"""The port's red/black SOR and FDM solvers against cfd_demo_tpu on the CPU.

Inputs are made with numpy from a seed and given to both packages. The
JAX side runs the Pallas kernels in interpret mode, as
tests/test_sor_pallas.py does (ny % 8 == 0, nx even for the colour
split); the port's kernel wrappers run their plain versions on CPU
tensors. Tolerances:

- one solve, plain against plain: 1e-6 max|p| (the same divisions; XLA
  and PyTorch may round a division by a constant differently);
- a kernel chain against its Pallas kernel: 1e-6 max|p|, the bound of
  tests/test_sor_pallas.py:41 (the kernels' reciprocal multipliers
  against the plain version's divisions, amplified by omega = 1.7);
- the whole step: the golden bounds of tests/test_golden.py;
- the batched substep against kernel 20's SOR form: 1e-4 for two
  warm-started 30-iteration substeps (tests/test_ensemble_pallas.py:183),
  2e-3 where a live tolerance may move a trip count by one (:214).
"""
import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cfd_demo_tpu as jc
from cfd_demo_tpu.kernels import sor_pallas as jsor
from cfd_demo_tpu.kernels.ensemble_pallas import substep_batch_pallas
from cfd_demo_tpu.ops import poisson as jpois
from cfd_demo_tpu.oracle.reference import NumpyModel
from cfd_demo_tpu.solver.piso import _substep_jnp as jsubstep

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch import cells
from cfd_demo_tpu_torch.apps import ensemble as tapp
from cfd_demo_tpu_torch.kernels import ensemble as kens
from cfd_demo_tpu_torch.kernels import sor as ksor
from cfd_demo_tpu_torch.ops import poisson as tpois
from cfd_demo_tpu_torch.solver import piso as tpiso

from conftest import l2
from test_torch_ensemble import batched_inputs
from test_torch_step import _assert_golden, oracle_field, t_field

torch.set_num_threads(1)

OMEGA = 1.7


def T(a):
    return torch.from_numpy(np.array(a))


def pp_rhs(shape, seed, scale=0.1):
    """BC-consistent p' and a rhs, as numpy f32."""
    rng = np.random.default_rng(seed)
    pp = tpois._apply_pprime_bcs(T(scale * rng.standard_normal(shape).astype(np.float32)))
    return pp.numpy(), rng.standard_normal(shape).astype(np.float32)


def atol_of(ref, rtol=1e-6):
    return rtol * max(1.0, float(np.max(np.abs(np.asarray(ref)))))


def assert_fields(got, ref, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol_of(ref, rtol))


# ---------------------------------------------------------------------------
# The plain solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("early_exit", [True, False])
def test_sor_matches_jax(early_exit):
    """One scene, with a live tolerance: the same exit, within ulps."""
    pp, rhs = pp_rhs((32, 40), seed=0)
    args = (1 / 40, 1 / 32, OMEGA, 1e-3, 50)
    ref = jpois.sor(jnp.asarray(pp), jnp.asarray(rhs), *args, early_exit=early_exit)
    got = tpois.sor(T(pp), T(rhs), *args, early_exit=early_exit)
    assert int(got[2]) == int(ref[2]) < 50
    assert_fields(got[0], ref[0])
    assert np.isclose(float(got[1]), float(ref[1]), rtol=1e-4, atol=1e-7)


def test_sor_batch_matches_vmapped_jax_and_skips_done_scenes():
    """The masked form on a batch: each scene exits at its own iteration,
    as the vmapped JAX solve; a scene flagged done is not swept."""
    B, ny, nx = 4, 16, 24
    pp, rhs = pp_rhs((B, ny, nx), seed=1)
    pp[1] *= 1e-3
    rhs[1] *= 1e-3  # scene 1 converges first
    args = (1 / nx, 1 / ny, OMEGA, 1e-4, 40)
    ref = jax.vmap(lambda a, b: jpois.sor(a, b, *args, early_exit=False))(
        jnp.asarray(pp), jnp.asarray(rhs))
    got = tpois.sor(T(pp), T(rhs), *args, early_exit=False)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert len(set(got[2].tolist())) > 1
    assert_fields(got[0], ref[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-4, atol=1e-7)
    done = torch.tensor([False, False, True, False])
    flagged = tpois.sor(T(pp), T(rhs), *args, early_exit=False, done=done)
    assert flagged[2].tolist() == [int(n) if not d else 0
                                   for n, d in zip(got[2], done)]
    assert torch.equal(flagged[0][2], T(pp[2])) and float(flagged[1][2]) == np.inf
    for k in (0, 1, 3):
        assert torch.equal(flagged[0][k], got[0][k])
    with pytest.raises(ValueError, match="one scene"):
        tpois.sor(T(pp), T(rhs), *args, early_exit=True)


def test_sor_lexicographic_matches_jax_and_oracle():
    """The wavefront sweep against the JAX one and against the scalar
    oracle's in-place row-major sweep (tests/test_sor_ordering.py:98-107:
    a few ulps a sweep)."""
    grid = jc.Grid(nx=24, ny=16, lx=4.0, ly=1.5)
    params = jc.SimulationParams(pressure_solver=jc.PressureSolver.SOR)
    opts = jc.solver_options_for(jc.Semantics.RUST, jacobi_iters=7, jacobi_tol=0.0,
                                 sor_ordering="lexicographic")
    pp, rhs = pp_rhs((16, 24), seed=2)
    args = (float(grid.dx), float(grid.dy), OMEGA, 0.0, 7)
    ref = jpois.sor_lexicographic(jnp.asarray(pp), jnp.asarray(rhs), *args)
    got = tpois.sor_lexicographic(T(pp), T(rhs), *args)
    want, err_want = NumpyModel(grid, params, opts)._sor_lexicographic(pp.copy(),
                                                                      rhs.copy())
    assert int(got[2]) == int(ref[2]) == 7
    assert_fields(got[0], ref[0])
    assert_fields(got[0], want)
    assert np.isclose(float(got[1]), float(err_want), rtol=1e-4, atol=1e-7)
    # a batch, masked, equals its scenes one by one
    two = np.stack([pp, 0.5 * pp]), np.stack([rhs, 0.5 * rhs])
    batch = tpois.sor_lexicographic(T(two[0]), T(two[1]), *args, early_exit=False)
    one = tpois.sor_lexicographic(T(two[0][1]), T(two[1][1]), *args)
    assert torch.equal(batch[0][1], one[0])


# ---------------------------------------------------------------------------
# The kernels' plain versions and chains against the Pallas kernels
# ---------------------------------------------------------------------------

def test_sor_fused_k_plain_matches_pallas():
    n = 64
    pp, rhs = pp_rhs((n, n), seed=3)
    ref = jsor.sor_fused_k(jnp.asarray(pp), jnp.asarray(rhs), 1 / n, 1 / n, OMEGA, 6,
                           interpret=True)
    got = ksor.sor_fused_k_plain(T(pp), T(rhs), 1 / n, 1 / n, OMEGA, 6)
    assert_fields(got[0], ref[0])
    assert np.isclose(float(got[1]), float(ref[1]), rtol=1e-4, atol=1e-7)
    wrapped = ksor.sor_fused_k(T(pp), T(rhs), 1 / n, 1 / n, OMEGA, 6)  # CPU: plain
    assert torch.equal(wrapped[0], got[0]) and torch.equal(wrapped[1], got[1])
    assert ksor.sor_fused_k.launches == 0


def _sizes(monkeypatch, wrapper, chain, *args, **kw):
    """The launch sizes a chain asks of ``wrapper`` (a name in
    kernels.sor, whose last argument is k), with the chain's result."""
    sizes = []
    plain = getattr(ksor, wrapper)

    def spy(*a):
        sizes.append(a[-1])
        return plain(*a)

    monkeypatch.setattr(ksor, wrapper, spy)
    return sizes, chain(*args, **kw)


@pytest.mark.parametrize("tol,iters", [(0.0, 13), ("between", 23)])
def test_sor_chain_matches_sor_pallas(monkeypatch, tol, iters):
    """13 = 2 x 5 + 3 runs [5, 5, 3]; with a live tolerance, set between
    the errors after 5 and 10 iterations (far from both), the 23 = 4 x 5 +
    3 chain exits after its second k-launch, as the Pallas chain does,
    and runs the remainder: [5, 5, 3] again, 13 iterations."""
    ny, nx = 32, 48
    pp, rhs = pp_rhs((ny, nx), seed=4)
    dx, dy = 1 / nx, 1 / ny
    if tol == "between":
        e5, e10 = (float(jpois.sor(jnp.asarray(pp), jnp.asarray(rhs), dx, dy, OMEGA,
                                   0.0, n, early_exit=False)[1]) for n in (5, 10))
        assert e10 < e5 / 2
        tol = float(np.sqrt(e5 * e10))
    ref = jsor.sor_pallas(jnp.asarray(pp), jnp.asarray(rhs), dx, dy, OMEGA, tol, iters,
                          k=5, early_exit=True, interpret=True)
    sizes, got = _sizes(monkeypatch, "sor_fused_k", ksor.sor_chain, T(pp), T(rhs), dx,
                        dy, OMEGA, tol, iters, k=5, early_exit=True)
    assert sizes == [5, 5, 3]
    assert got[2] == int(ref[2]) == 13
    assert_fields(got[0], ref[0])
    assert np.isclose(float(got[1]), float(ref[1]), rtol=1e-4, atol=1e-7)


def test_sor_compress_bit_for_bit():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((24, 40)).astype(np.float32)
    ref = jsor.sor_compress(jnp.asarray(x))
    got = ksor.sor_compress(T(x))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = ksor.sor_decompress(*got)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jsor.sor_decompress(*ref)))
    assert torch.equal(back, T(x))
    with pytest.raises(ValueError, match="even"):
        ksor.sor_compress(T(x[:, :39]))


def _schedule(monkeypatch, *args, **kw):
    """The launch sizes sor_chain_rb2 takes, with its result."""
    return _sizes(monkeypatch, "sor_fused_k_rb2", ksor.sor_chain_rb2, *args, **kw)


def test_sor_chain_rb2_matches_sor_pallas_rb2(monkeypatch):
    """tests/test_sor_pallas.py:153-189: the fixed schedule folds 17 =
    3 x 5 + 2 into [5, 5, 7]; an unreachable live tolerance keeps
    uniform-k launches plus the remainder; the fields are the same."""
    ny, nx = 32, 64
    pp, rhs = pp_rhs((ny, nx), seed=6)
    dx, dy = 1 / nx, 1 / ny
    ref = jsor.sor_pallas_rb2(jnp.asarray(pp), jnp.asarray(rhs), dx, dy, 1.6, 0.0, 17,
                              k=5, early_exit=False, interpret=True)
    sizes, got = _schedule(monkeypatch, T(pp), T(rhs), dx, dy, 1.6, 0.0, 17, k=5,
                           early_exit=False)
    assert sizes == [5, 5, 7] and got[2] == int(ref[2]) == 17
    assert_fields(got[0], ref[0])
    assert np.isclose(float(got[1]), float(ref[1]), rtol=1e-4, atol=1e-7)
    sizes_a, got_a = _schedule(monkeypatch, T(pp), T(rhs), dx, dy, 1.6, 1e-30, 17, k=5,
                               early_exit=True)
    assert sizes_a == [5, 5, 5, 2] and got_a[2] == 17
    assert_fields(got_a[0], got[0])


def test_sor_chain_rb2_bench_schedule(monkeypatch):
    """bench.py's 50 iterations at the port's k = 8: [8, 8, 8, 8, 8, 10]."""
    pp, rhs = pp_rhs((8, 12), seed=7)
    sizes, got = _schedule(monkeypatch, T(pp), T(rhs), 1 / 12, 1 / 8, OMEGA, 0.0, 50,
                           k=8, early_exit=False)
    assert sizes == [8, 8, 8, 8, 8, 10] and got[2] == 50
    want = tpois.sor(T(pp), T(rhs), 1 / 12, 1 / 8, OMEGA, 0.0, 50, early_exit=False)
    assert_fields(got[0], want[0])


def test_sor_fused_k_rb2_plain_matches_pallas():
    """One launch on odd-height arrays with an odd half width (ny = 24, nx
    = 42: nx/2 = 21), every fold and the BCs' colour crossing."""
    ny, nx = 24, 42
    pp, rhs = pp_rhs((ny, nx), seed=8)
    jr = jsor.sor_compress(jnp.asarray(pp)) + jsor.sor_compress(jnp.asarray(rhs))
    ref = jsor.sor_fused_k_rb2(*jr, nx, 1 / nx, 1 / ny, OMEGA, 4, interpret=True)
    tr = ksor.sor_compress(T(pp)) + ksor.sor_compress(T(rhs))
    got = ksor.sor_fused_k_rb2(*tr, 1 / nx, 1 / ny, OMEGA, 4)
    for a, b in zip(got, ref):
        assert_fields(a, b)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def sor_golden_setup(**opt_overrides):
    """tests/test_golden.py's small grid with Rust/FIRST/SOR."""
    def grid(m):
        return m.Grid(nx=24, ny=16, lx=4.0, ly=1.5,
                      obstacles=(m.Cylinder(center_x=1.0, center_y=0.75, radius=0.3),))

    def params(m):
        return m.SimulationParams(dt=0.004, viscosity=1e-4, target_inlet_velocity=1.0,
                                  pressure_solver=m.PressureSolver.SOR)

    scenes = [m.make_scene(grid(m), params(m),
                           m.solver_options_for(m.Semantics.RUST, **opt_overrides))
              for m in (jc, tc)]
    oracle = NumpyModel(grid(jc), params(jc),
                        jc.solver_options_for(jc.Semantics.RUST, **opt_overrides))
    return scenes[0], scenes[1], oracle


def test_sor_fixed_iters_matches_oracle_and_jax():
    """Golden layer 1 (tests/test_golden.py:74-99): zero tolerances, 4
    outer rounds; the solve takes the kernel-13 chain (tol == 0)."""
    jscene, tscene, oracle = sor_golden_setup(
        ramp_up_steps=3, jacobi_tol=0.0, outer_corrector_tol=0.0,
        jacobi_iters=10, outer_corrector_rounds=4)
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


def test_sor_real_constants_match_oracle_and_jax():
    """Golden layer 2 (tests/test_golden.py:103-146): the reference's
    tolerance, exact exits and 20 outer rounds (the plain sor)."""
    jscene, tscene, oracle = sor_golden_setup(ramp_up_steps=4)
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


def _bench_sor_scenes(nx, ny):
    """bench.py --mode sor (bench.py:105-116) on a small grid with the
    fused route forced and the cylinder widened to span a few cells."""
    out = []
    for m in (jc, tc):
        grid = m.Grid(nx=nx, ny=ny, lx=30.0, ly=30.0 * ny / nx,
                      obstacles=(m.Cylinder(7.5, 15.0 * ny / nx, 3.0),))
        opts = m.solver_options_for(
            m.Semantics.RUST, ramp_up_steps=10, jacobi_tol=0.0, jacobi_iters=50,
            outer_corrector_rounds=0, early_exit=False, substep_impl="pallas",
            pressure_impl="pallas")
        out.append(m.make_scene(grid, m.SimulationParams(
            dt=0.002, viscosity=1e-4, pressure_solver=m.PressureSolver.SOR), opts))
    return out


@pytest.mark.parametrize("layout", ["rb2", "full"])
def test_fused_sor_route_matches_jax(monkeypatch, layout):
    """The fused route (predict_div, the SOR chain, correct_bc) against
    the JAX step, 5 steps at tol = 0. The colour split is taken at >= 2M
    cells with nx even; lowering that threshold takes it here, and an odd
    nx takes the full-layout chain."""
    monkeypatch.setattr(tpiso, "FUSED_MIN_CELLS", 0)
    nx = 64 if layout == "rb2" else 63
    jscene, tscene = _bench_sor_scenes(nx, 48)
    chains = []
    for name in ("sor_chain", "sor_chain_rb2"):
        fn = getattr(tpiso, name)
        monkeypatch.setattr(tpiso, name, lambda *a, _f=fn, _n=name, **kw:
                            (chains.append(_n), _f(*a, **kw))[1])
    js, jd = jc.make_run(jscene, 5, donate=False)(jscene.init_state())
    ts, td = tc.make_run(tscene, 5)(tscene.init_state(device="cpu"))
    assert set(chains) == {"sor_chain_rb2" if layout == "rb2" else "sor_chain"}
    # p sums five solves' p', and over-relaxed sweeps carry an ulp-level
    # difference furthest in the near-uniform mode: the golden layer-2
    # bounds (u, v, grad p and mean-removed p, tests/test_golden.py:14-24)
    g = tscene.grid
    _assert_golden(ts, {"u": js.u, "v": js.v, "p": js.p, "dt": js.dt}, g.dx, g.dy,
                   layout)
    for f in ("dt", "res_u", "res_v", "res_p"):
        np.testing.assert_allclose(getattr(td, f).numpy(), np.asarray(getattr(jd, f)),
                                   rtol=1e-4, atol=1e-7, err_msg=f)
    assert float(ts.u.abs().max()) >= 0.4


def _spy(monkeypatch, calls, names):
    for name in names:
        fn = getattr(tpiso, name)
        monkeypatch.setattr(tpiso, name, lambda *a, _f=fn, _n=name, **kw:
                            (calls.append(_n), _f(*a, **kw))[1])


SPIED = ("predict_div", "correct_bc", "solve_correct_rounds", "sor_chain",
         "sor_chain_rb2", "sor", "sor_lexicographic", "substep_batch", "_substep_jnp")


@pytest.mark.parametrize("route", ["rb2", "full-layout", "plain", "lexicographic",
                                   "800x264", "batch-kernel20", "batch-too-large",
                                   "batch-lexicographic"])
def test_sor_route_table(monkeypatch, route):
    """piso.py's SOR rows: which wrappers a step calls."""
    calls = []
    _spy(monkeypatch, calls, SPIED)
    batch = route.startswith("batch")
    if route in ("rb2", "full-layout"):
        monkeypatch.setattr(tpiso, "FUSED_MIN_CELLS", 0)
        _, scene = _bench_sor_scenes(32 if route == "rb2" else 33, 24)
        scene = dataclasses.replace(scene, opts=dataclasses.replace(
            scene.opts, substep_impl="auto", pressure_impl="auto", jacobi_iters=5))
        want = {"predict_div", "correct_bc",
                "sor_chain_rb2" if route == "rb2" else "sor_chain"}
    elif route == "800x264":
        # the Rust app's scene with --solver sor: tol > 0 below 2M cells is
        # the plain solve, as on the TPU (JAX piso.py:423-426); never the
        # rounds kernel
        scene = tc.make_scene(tc.default_grid(), tc.SimulationParams(
            pressure_solver=tc.PressureSolver.SOR))
        want = {"_substep_jnp", "sor"}
    else:
        extra = {"lexicographic": {"sor_ordering": "lexicographic"},
                 "batch-lexicographic": {"sor_ordering": "lexicographic"}}.get(route, {})
        _, scene, _ = sor_golden_setup(early_exit=not batch, **extra)
        lex = "lexicographic" in route
        want = {"_substep_jnp", "sor_lexicographic" if lex else "sor"}
        if route == "batch-kernel20":
            # on CPU tensors kernel 20 runs its plain version, the plain
            # batched substep
            want = {"substep_batch", "_substep_jnp", "sor"}
        if route == "batch-too-large":
            monkeypatch.setattr(tpiso, "substep_batch_takes",
                                lambda scene, batch, device: False)
    state = scene.init_state(device="cpu")
    if batch:
        state = tc.batch_state(state, 2)
    state, _ = tc.make_step(scene)(state)
    assert set(calls) == want
    assert bool(torch.isfinite(state.u).all())


# ---------------------------------------------------------------------------
# FDM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rounds", [0, 3])
def test_fdm_step_matches_jax(rounds):
    """PressureSolver.FDM: the exact interior solve, err the post-solve
    residual, a count of 1 (JAX piso.py:475-497), one scene, 3 steps."""
    def setup(m):
        grid = m.Grid(nx=24, ny=16, lx=4.0, ly=1.5,
                      obstacles=(m.Cylinder(center_x=1.0, center_y=0.75, radius=0.3),))
        return m.make_scene(grid, m.SimulationParams(
            dt=0.004, viscosity=1e-4, pressure_solver=m.PressureSolver.FDM),
            m.solver_options_for(m.Semantics.RUST, ramp_up_steps=3,
                                 outer_corrector_rounds=rounds))
    jscene, tscene = setup(jc), setup(tc)
    js, jd = jc.make_run(jscene, 3, donate=False)(jscene.init_state())
    ts, td = tc.make_run(tscene, 3)(tscene.init_state(device="cpu"))
    g = tscene.grid
    _assert_golden(ts, {"u": js.u, "v": js.v, "p": js.p, "dt": js.dt}, g.dx, g.dy, "fdm")
    # err is the f32 residual of an exact solve: noise, held to its scale
    scale = float(np.max(np.abs(np.asarray(jd.res_p)))) + 1e-6
    assert float(td.res_p.abs().max()) <= 100 * scale
    pp, err, n = tpiso._solve_pressure(tscene, ts.p_prime, torch.ones(16, 24), ts.dt)
    denom = 2 / g.dx ** 2 + 2 / g.dy ** 2
    assert int(n) == 1
    assert float(err) <= 1e-5 * (denom * float(pp.abs().max()) + 1.0)  # f32 noise


def test_fdm_and_sor_batches():
    """A SOR batch steps (the tests above hold it); FDM, like
    MG_PRODUCTION, takes one scene."""
    _, scene, _ = sor_golden_setup(early_exit=False)
    fdm = dataclasses.replace(scene, params=dataclasses.replace(
        scene.params, pressure_solver=tc.PressureSolver.FDM))
    with pytest.raises(NotImplementedError, match="batched fdm.*queue 1 item 7"):
        tc.make_step(fdm)(tc.batch_state(fdm.init_state("cpu"), 2))


# ---------------------------------------------------------------------------
# The batch: kernel 20's SOR form
# ---------------------------------------------------------------------------

def ens_scenes(nx, ny, lx, ly, cyl, **opts):
    return [m.make_scene(
        m.Grid(nx=nx, ny=ny, lx=lx, ly=ly, obstacles=(m.Cylinder(*cyl),)),
        m.SimulationParams(dt=0.002, viscosity=1e-4, pressure_solver=m.PressureSolver.SOR),
        m.solver_options_for(m.Semantics.RUST, early_exit=False, **opts))
        for m in (jc, tc)]


def test_substep_batch_sor_plain_matches_pallas_kernel():
    """tests/test_ensemble_pallas.py:150-188 (Rust): two substeps, the
    second warm-started, at tol = 0 and 30 iterations."""
    B = 4
    jscene, tscene = ens_scenes(40, 24, 3.0, 1.5, (0.9, 0.75, 0.3),
                                outer_corrector_rounds=0, jacobi_tol=0.0,
                                jacobi_iters=30)
    u, v, p, pp = batched_inputs(tscene.grid, B, seed=2)
    nus = np.geomspace(1e-5, 1e-3, B).astype(np.float32)
    dts = np.full((B,), 0.002, np.float32)
    inls = np.linspace(0.5, 1.5, B).astype(np.float32)
    kern = jax.jit(lambda *a: substep_batch_pallas(*a, jscene, interpret=True))
    r1 = kern(u, v, p, pp, dts, nus, inls)
    r2 = kern(r1[0], r1[1], r1[2], r1[3], dts, nus, inls)
    rest = [T(x) for x in (dts, nus, inls)]
    g1 = kens.substep_batch_plain(*(T(x) for x in (u, v, p, pp)), *rest, tscene)
    g2 = kens.substep_batch_plain(*g1[:4], *rest, tscene)
    for name, r, g in zip(("u", "v", "p", "pp", "err"), r2, g2):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    assert g2[5].tolist() == [[0, 30]] * B
    # the wrapper on CPU tensors is the plain version, for either entry
    for entry in (kens.substep_batch, kens.substep_batch_sor):
        w = entry(*g1[:4], *rest, tscene)
        assert all(torch.equal(a, b) for a, b in zip(w, g2))
    assert kens.substep_batch_sor.launches == 0 == kens.substep_batch.launches


def test_substep_batch_sor_early_exit_close():
    """tests/test_ensemble_pallas.py:191-214: a live tolerance, where a
    trip count may differ by one at a float knife edge."""
    B = 3
    jscene, tscene = ens_scenes(40, 24, 3.0, 1.5, (0.9, 0.75, 0.3),
                                outer_corrector_rounds=0)
    u, v, p, pp = batched_inputs(tscene.grid, B, seed=3)
    nus = np.asarray([1e-5, 1e-4, 1e-3], np.float32)
    dts = np.full((B,), 0.002, np.float32)
    inls = np.full((B,), 1.0, np.float32)
    ref = jax.jit(lambda *a: substep_batch_pallas(*a, jscene, interpret=True))(
        u, v, p, pp, dts, nus, inls)
    got = kens.substep_batch_plain(*(T(x) for x in (u, v, p, pp, dts, nus, inls)), tscene)
    for name, r, g in zip(("u", "v", "p", "pp", "err"), ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-3, atol=2e-3,
                                   err_msg=name)
    vm = jax.vmap(partial(jsubstep, jscene))(u, v, p, pp, dts, nus, inls)
    for name, r, g in zip(("u", "v", "p", "pp"), vm, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5,
                                   err_msg=f"vmapped {name}")


def test_sor_scene_k_equals_its_unbatched_run():
    """Scene k of a SOR batch with outer rounds is the port's unbatched
    run with nu_k, for 3 steps (each scene freezes on its own)."""
    B, k = 4, 2
    _, scene = ens_scenes(32, 24, 2.0, 1.5, (0.6, 0.75, 0.25), ramp_up_steps=2)
    nus = torch.linspace(1e-4, 1e-2, B)
    batch = tc.batch_state(scene.init_state("cpu"), B, nu=nus)
    batch, diags = tc.make_run(scene, 3)(batch)
    assert diags.res_p.shape == (3, B)
    one = dataclasses.replace(scene.init_state("cpu"), nu=nus[k].clone())
    one, _ = tc.make_run(scene, 3)(one)
    for f in ("u", "v", "p", "p_prime", "dt", "res_u", "res_v", "res_p"):
        torch.testing.assert_close(getattr(batch, f)[k], getattr(one, f),
                                   rtol=0, atol=1e-6, msg=f)
    assert not torch.allclose(batch.u[0], batch.u[-1])


def test_ensemble_app_with_sor_on_the_cpu(capsys):
    argv = ["--batch", "3", "--nx", "32", "--ny", "16", "--steps", "4",
            "--chunk", "2", "--device", "cpu", "--solver", "sor"]
    assert tapp.main(argv) == 0
    out = capsys.readouterr().out
    assert "scene-steps/s" in out and "cell-updates/s aggregate" in out


# ---------------------------------------------------------------------------
# The cells
# ---------------------------------------------------------------------------

def _bench_jax_scene(mode, n):
    """bench.py:78-116's scene for ``mode`` at n², in the JAX package."""
    grid = jc.Grid(nx=n, ny=n, lx=30.0, ly=30.0,
                   obstacles=(jc.Cylinder(7.5, 15.0, 0.75),))
    solver = {"sor": jc.PressureSolver.SOR, "fdm": jc.PressureSolver.FDM}[mode]
    params = jc.SimulationParams(dt=0.002, viscosity=1e-4, pressure_solver=solver)
    if mode == "sor":
        opts = jc.solver_options_for(
            jc.Semantics.RUST, ramp_up_steps=10, jacobi_tol=0.0, jacobi_iters=50,
            outer_corrector_rounds=0, early_exit=False, pressure_impl="auto",
            pallas_fuse_k=0)
    else:
        opts = jc.solver_options_for(jc.Semantics.RUST, ramp_up_steps=10,
                                     outer_corrector_rounds=0, pressure_impl="auto",
                                     pallas_fuse_k=0)
    return jc.make_scene(grid, params, opts)


@pytest.mark.parametrize("mode,n", [("sor", 2048), ("sor", 2047), ("fdm", 2048)])
def test_sor_and_fdm_cells_are_bench_modes(mode, n):
    scene = {"sor": cells.sor_scene, "fdm": cells.fdm_scene}[mode](n)
    want = _bench_jax_scene(mode, n)
    for part in ("grid", "params", "opts"):
        assert repr(getattr(scene, part)) == repr(getattr(want, part)), part
    assert tpiso._use_fused_substep(scene)


def test_sor_cells():
    make, _, _, batch = cells.CELLS["2048^2 sor"]
    assert make().params.pressure_solver == tc.PressureSolver.SOR and batch is None
    make, _, _, batch = cells.CELLS["ensemble 16x256x96 sor"]
    scene = make()
    assert batch == 16 and kens.substep_batch_fits(scene.grid)
    assert scene.params.pressure_solver == tc.PressureSolver.SOR
    assert repr(scene.grid) == repr(tapp.ensemble_scene().grid)
