"""The port's batched ensemble against cfd_demo_tpu on the CPU.

Kernel 20 (the whole-substep ensemble kernel) and kernel 12 (the batched
Jacobi solve) run here as their plain versions, held against the Pallas
kernels in interpret mode at the bounds of tests/test_ensemble_pallas.py;
the batched step is held against the JAX package's vmapped step
(tests/test_sharding.py:134-173) and against the port's own unbatched
runs. Inputs are made with numpy from a seed.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cfd_demo_tpu as jc
from cfd_demo_tpu.apps import common as jcommon
from cfd_demo_tpu.kernels.ensemble_pallas import substep_batch_pallas
from cfd_demo_tpu.kernels.jacobi_pallas import jacobi_pallas_batch
from cfd_demo_tpu.solver.piso import step_fn as jstep_fn

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch import cells
from cfd_demo_tpu_torch.apps import common as tcommon
from cfd_demo_tpu_torch.apps import ensemble as tapp
from cfd_demo_tpu_torch.kernels import cluster as kcl
from cfd_demo_tpu_torch.kernels import ensemble as kens
from cfd_demo_tpu_torch.kernels import jacobi_batch as kjb
from cfd_demo_tpu_torch.kernels._build import scene_scalars
from cfd_demo_tpu_torch.ops.bc import apply_bcs
from cfd_demo_tpu_torch.ops.poisson import _apply_pprime_bcs
from cfd_demo_tpu_torch.solver import piso as tpiso

from conftest import l2

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def scenes(nx, ny, lx, ly, cyl, dt=0.002, **opts):
    """The same scene in both packages, Rust/FIRST/CHANNEL, masked
    iteration (early_exit=False) as the ensemble runs it."""
    return [m.make_scene(
        m.Grid(nx=nx, ny=ny, lx=lx, ly=ly,
               obstacles=(m.Cylinder(*cyl),) if cyl else ()),
        m.SimulationParams(dt=dt, viscosity=1e-4),
        m.solver_options_for(m.Semantics.RUST, early_exit=False, **opts))
        for m in (jc, tc)]


def batched_inputs(grid, B, seed):
    """tests/test_ensemble_pallas.py:22-35: noisy fields, zero p'."""
    rng = np.random.default_rng(seed)
    ny, nx = grid.ny, grid.nx
    noisy = lambda shape, s: (s * rng.standard_normal((B,) + shape)).astype(np.float32)
    return (noisy((ny, nx + 1), 0.05), noisy((ny, nx), 0.05),
            noisy((ny, nx), 0.01), np.zeros((B, ny, nx), np.float32))


def test_substep_batch_plain_matches_pallas_kernel():
    """tests/test_ensemble_pallas.py:38-70, the Rust/FIRST/CHANNEL case."""
    B = 4
    jscene, tscene = scenes(40, 24, 3.0, 1.5, (0.9, 0.75, 0.3))
    u, v, p, pp = batched_inputs(tscene.grid, B, seed=0)
    nus = np.geomspace(1e-5, 1e-3, B).astype(np.float32)
    dts = np.full((B,), 0.002, np.float32)
    inls = np.linspace(0.5, 1.5, B).astype(np.float32)
    ref = jax.jit(lambda *a: substep_batch_pallas(*a, jscene, interpret=True))(
        u, v, p, pp, dts, nus, inls)
    args = [T(x) for x in (u, v, p, pp, dts, nus, inls)]
    got = kens.substep_batch_plain(*args, tscene)
    wrapped = kens.substep_batch(*args, tscene)  # a CPU tensor: the plain version
    for name, r, a, w in zip(("u", "v", "p", "pp", "err"), ref, got, wrapped):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        assert torch.equal(a, w), name
    assert got[5].shape == (B, 2) and got[5].dtype == torch.int32


def test_substep_batch_warm_start_rounds():
    """tests/test_ensemble_pallas.py:73-98: the second substep from the
    first's p' (the Rust warm start) with per-scene outer-round exits."""
    B = 3
    jscene, tscene = scenes(32, 16, 2.0, 1.0, (0.5, 0.5, 0.2))
    u, v, p, pp = batched_inputs(tscene.grid, B, seed=1)
    nus = np.asarray([1e-5, 1e-4, 1e-3], np.float32)
    dts = np.full((B,), 0.002, np.float32)
    inls = np.full((B,), 1.0, np.float32)
    kern = jax.jit(lambda *a: substep_batch_pallas(*a, jscene, interpret=True))
    r1 = kern(u, v, p, pp, dts, nus, inls)
    r2 = kern(r1[0], r1[1], r1[2], r1[3], dts, nus, inls)
    rest = [T(x) for x in (dts, nus, inls)]
    g1 = kens.substep_batch_plain(*(T(x) for x in (u, v, p, pp)), *rest, tscene)
    g2 = kens.substep_batch_plain(*g1[:4], *rest, tscene)
    for name, r, g in zip(("u", "v", "p", "pp", "err"), r2, g2):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5, atol=2e-5,
                                   err_msg=name)
    assert (g2[5][:, 0] > 0).all()  # outer rounds ran in the second substep


def _pp_rhs(shape, seed):
    rng = np.random.default_rng(seed)
    pp = _apply_pprime_bcs(T(0.1 * rng.standard_normal(shape).astype(np.float32)))
    rhs = rng.standard_normal(shape).astype(np.float32)
    return pp.numpy(), rhs


@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_jacobi_batch_plain_matches_pallas_kernel(tol):
    B, ny, nx = 3, 16, 24
    pp, rhs = _pp_rhs((B, ny, nx), seed=2)
    pp[1] *= 1e-3  # scene 1 converges within the 40 sweeps at tol 1e-4
    rhs[1] *= 1e-3
    dx, dy, om, iters = 1 / nx, 1 / ny, 0.75, 40
    ref = jacobi_pallas_batch(jnp.asarray(pp), jnp.asarray(rhs), dx, dy, om, tol,
                              iters, interpret=True)
    got = kjb.jacobi_batch_plain(T(pp), T(rhs), dx, dy, om, tol, iters)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    if tol == 0.0:
        for r, g in zip(ref[:2], got[:2]):
            atol = 1e-6 * max(1.0, float(np.max(np.abs(np.asarray(r)))))
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=atol)
    else:
        assert int(got[2][1]) < iters  # an early exit was held to the kernel's
    w = kjb.jacobi_batch(T(pp), T(rhs), dx, dy, om, tol, iters)
    assert all(torch.equal(a, b) for a, b in zip(w, got))


def test_jacobi_batch_plain_skips_scenes_flagged_done():
    """The masked rounds hand the solve their converged scenes: those
    keep p' and run no sweep, the others run as without the flags."""
    B, ny, nx = 3, 16, 24
    pp, rhs = (T(x) for x in _pp_rhs((B, ny, nx), seed=3))
    args = (1 / nx, 1 / ny, 0.75, 1e-4, 40)
    free = kjb.jacobi_batch_plain(pp, rhs, *args)
    done = torch.tensor([False, True, False])
    got = kjb.jacobi_batch(pp, rhs, *args, done=done)  # CPU: the plain version
    assert got[2].tolist() == [int(free[2][0]), 0, int(free[2][2])]
    assert torch.equal(got[0][1], pp[1])
    for k in (0, 2):
        assert torch.equal(got[0][k], free[0][k]) and got[1][k] == free[1][k]
    none = kjb.jacobi_batch_plain(pp, rhs, *args, done=torch.ones(B, dtype=torch.bool))
    assert torch.equal(none[0], pp) and not none[2].any()
    with pytest.raises(ValueError, match="bool"):
        kjb.jacobi_batch(pp, rhs, *args, done=torch.zeros(B))


def _vmap_setup(B=8):
    """tests/test_sharding.py:134-173: 32x24, no obstacle, ramp 5."""
    jscene, tscene = scenes(32, 24, 2.0, 1.5, None, ramp_up_steps=5)
    nus = np.linspace(1e-4, 1e-3, B).astype(np.float32)
    jbase = jscene.init_state()
    jb = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), jbase)
    jb = dataclasses.replace(jb, nu=jnp.asarray(nus))
    tb = tc.batch_state(tscene.init_state("cpu"), B, nu=T(nus))
    return jscene, tscene, jb, tb, nus


def test_batched_step_matches_vmapped_jax_step():
    jscene, tscene, jb, tb, _ = _vmap_setup()
    jstep = jax.jit(jax.vmap(partial(jstep_fn, jscene)))
    tstep = tc.make_step(tscene)
    g = tscene.grid
    for k in range(3):
        jb, jd = jstep(jb)
        tb, td = tstep(tb)
        for b in range(tb.u.shape[0]):
            for f in ("u", "v"):
                want = np.asarray(getattr(jb, f)[b], np.float64)
                scale = max(1.0, float(np.sqrt(np.mean(want ** 2))))
                assert l2(getattr(tb, f)[b].numpy(), want) <= 1e-5 * scale, (k, b, f)
            # tests/test_golden.py:116-141
            gp = tb.p[b].numpy().astype(np.float64)
            op = np.asarray(jb.p[b], np.float64)
            gscale = max(1.0, float(np.sqrt(np.mean((np.diff(op, axis=1) / g.dx) ** 2))))
            gx = l2(np.diff(gp, axis=1) / g.dx, np.diff(op, axis=1) / g.dx)
            gy = l2(np.diff(gp, axis=0) / g.dy, np.diff(op, axis=0) / g.dy)
            assert max(gx, gy) <= 1e-4 * gscale, (k, b, "grad p")
            d = gp - op
            d -= d.mean()
            pscale = max(1.0, float(np.sqrt(np.mean(op ** 2))))
            assert float(np.sqrt(np.mean(d ** 2))) <= 1e-5 * pscale, (k, b, "p")
        np.testing.assert_allclose(td.dt.numpy(), np.asarray(jd.dt), rtol=1e-5,
                                   atol=1e-8)
        np.testing.assert_allclose(tb.dt.numpy(), np.asarray(jb.dt), rtol=1e-5,
                                   atol=1e-8)
        np.testing.assert_allclose(td.res_p.numpy(), np.asarray(jd.res_p),
                                   rtol=1e-3, atol=1e-7)
        assert td.res_u.shape == (tb.u.shape[0],)
    u = tb.u.numpy()
    assert np.isfinite(u).all() and not np.allclose(u[0], u[-1])


@pytest.mark.parametrize("B,nx,ny,k", [(4, 32, 24, 3), (12, 12, 10, 5)])
def test_scene_k_equals_its_unbatched_run(B, nx, ny, k):
    """Each scene freezes on its own: scene k of the batch is the port's
    unbatched run with nu_k (the rounds route), for 3 steps. With B equal
    to nx, a (B,) scalar broadcast against the last axis would pass
    silently."""
    _, scene = scenes(nx, ny, 2.0, 1.5, (0.6, 0.75, 0.25), ramp_up_steps=2)
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


def test_per_scene_inlet_bc():
    grid = tc.Grid(nx=6, ny=4, lx=1.0, ly=1.0)
    u = torch.zeros(3, 4, 7)
    v = torch.ones(3, 4, 6)
    inlet = torch.tensor([1.0, 2.0, 3.0])
    ub, vb = apply_bcs(u, v, grid, tc.InletProfile.UNIFORM, inlet, None, None)
    assert torch.equal(ub[:, 1:-1, 0], inlet[:, None].expand(3, 2))
    assert not ub[:, 0].any() and not ub[:, -1].any() and not vb[:, 0].any()


def test_state_round_trip_of_a_vmapped_jax_state():
    jscene, tscene, jb, tb, _ = _vmap_setup(B=4)
    jb, _ = jax.jit(jax.vmap(partial(jstep_fn, jscene)))(jb)
    d = {f.name: (None if getattr(jb, f.name) is None
                  else np.asarray(getattr(jb, f.name)))
         for f in dataclasses.fields(jb)}
    back = tc.state_to_numpy(tc.state_from_numpy(d, "cpu"))
    assert set(back) == set(d)
    for k, a in d.items():
        if a is None:
            assert back[k] is None
        else:
            assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
            np.testing.assert_array_equal(back[k], a)
    assert back["u"].shape == (4,) + tscene.grid.shape_u
    assert back["nu"].shape == (4,)


def test_batch_state():
    _, scene = scenes(8, 6, 1.0, 1.0, None)
    base = scene.init_state("cpu")
    b = tc.batch_state(base, 3, nu=torch.tensor([1.0, 2.0, 3.0]))
    assert b.u.shape == (3, 6, 9) and b.u.is_contiguous()
    assert b.step.shape == (3,) and b.step.dtype == torch.int32
    assert b.nu.tolist() == [1.0, 2.0, 3.0] and b.u_prev is None
    with pytest.raises(ValueError):
        tc.batch_state(base, 3, nu=torch.ones(4))
    with pytest.raises(TypeError):
        tc.batch_state(base, 3, viscosity=torch.ones(3))


def test_scene_scalars():
    s = scene_scalars("cpu", 3, 0.5, torch.tensor(2.0), torch.tensor([1.0, 2.0, 3.0]))
    assert s.shape == (3, 3) and s.is_contiguous()
    assert s[:, 0].tolist() == [0.5] * 3 and s[:, 1].tolist() == [2.0] * 3
    assert s[:, 2].tolist() == [1.0, 2.0, 3.0]
    with pytest.raises(ValueError):
        scene_scalars("cpu", 3, torch.ones(2))


# Kernel wrappers: on the CPU they run their plain versions, whose own
# calls are not the route's.
WRAPPERS = {"substep_batch", "jacobi_batch", "solve_correct_rounds",
            "predict_div", "correct_bc", "jacobi_chain"}


def _spy(monkeypatch, name, calls, inside):
    fn = getattr(tpiso, name)

    def wrapped(*a, **kw):
        if inside:
            return fn(*a, **kw)
        calls.append(name)
        if name in WRAPPERS:
            inside.append(name)
        try:
            return fn(*a, **kw)
        finally:
            if name in WRAPPERS:
                inside.pop()

    monkeypatch.setattr(tpiso, name, wrapped)


@pytest.mark.parametrize("route", ["kernel20", "kernel20-forced", "too-large",
                                   "substep-jnp", "pressure-jnp"])
def test_batched_route_table(monkeypatch, route):
    """piso.py's batch rows: which wrappers a batched step calls, and
    never a single-scene route."""
    calls, inside = [], []
    for name in ("substep_batch", "_substep_jnp", "jacobi_batch",
                 "jacobi_batch_plain", "solve_correct_rounds", "predict_div",
                 "correct_bc", "jacobi_chain", "jacobi", "multigrid_production"):
        _spy(monkeypatch, name, calls, inside)
    opts = {"kernel20": {}, "kernel20-forced": {"substep_impl": "pallas"},
            "too-large": {}, "substep-jnp": {"substep_impl": "jnp"},
            "pressure-jnp": {"pressure_impl": "jnp"}}[route]
    _, scene = scenes(24, 16, 2.0, 1.5, (0.6, 0.75, 0.25), **opts)
    if route == "too-large":
        monkeypatch.setattr(tpiso, "substep_batch_takes", lambda scene, batch, device: False)
    want = {"kernel20": {"substep_batch"}, "kernel20-forced": {"substep_batch"},
            "too-large": {"_substep_jnp", "jacobi_batch"},
            "substep-jnp": {"_substep_jnp", "jacobi_batch"},
            "pressure-jnp": {"_substep_jnp", "jacobi_batch_plain"}}[route]
    tc.make_step(scene)(tc.batch_state(scene.init_state("cpu"), 2))
    assert set(calls) == want


# case -> (nx, ny, solver, whether kernel 20 takes the batch on a card
# that admits its cluster, on one that admits none, whether the card is
# asked)
ROUTES = {"block": (256, 96, "JACOBI", True, True, True),
          "cluster": (800, 264, "JACOBI", True, False, True),
          "wide": (1100, 30, "JACOBI", False, False, False),
          "sor-beyond-block": (800, 264, "SOR", False, False, False)}


@pytest.mark.parametrize("case", list(ROUTES))
def test_kernel20_route_test(monkeypatch, case):
    """``substep_batch_takes``, piso's route test for a batch: kernel 20
    takes a scene inside the block form's gate (the app's 256x96), and a
    Jacobi scene beyond it that a cluster holds (800x264) where the card
    admits that cluster; a scene wider than 1024 columns and a SOR scene
    beyond the gate keep the plain batched substep (kernel 12, the masked
    sor). The card's pick (kernels.cluster.pick_ctas) is stubbed, and
    asked only where a cluster holds the scene and the gate lets the
    solver through. A step on the CPU takes the route the shape gives."""
    nx, ny, solver, admits, refuses, asks = ROUTES[case]
    grid = tc.Grid(nx=nx, ny=ny, lx=30.0, ly=10.0, obstacles=(tc.Cylinder(7.5, 5.0, 0.75),))
    scene = tc.make_scene(
        grid, tc.SimulationParams(dt=0.004, pressure_solver=tc.PressureSolver[solver]),
        tc.solver_options_for(tc.Semantics.RUST, early_exit=False, jacobi_iters=2,
                              outer_corrector_rounds=1))
    card = torch.device("cuda", 0)
    for ctas, want in ((14, admits), (None, refuses)):
        asked = []

        def pick(entry, batch, ny, nx, device, *extra):
            asked.append((batch, ny, nx, device))
            return ctas

        monkeypatch.setattr(kcl, "pick_ctas", pick)
        kcl.plan.cache_clear()
        assert kens.substep_batch_takes(scene, 8, card) is want
        assert asked == ([(8, ny, nx, card)] if asks else [])
        assert kens.substep_batch_takes(scene, 8, "cpu") is admits
    kcl.plan.cache_clear()
    calls, inside = [], []
    for name in ("substep_batch", "_substep_jnp", "jacobi_batch", "sor"):
        _spy(monkeypatch, name, calls, inside)
    tc.make_step(scene)(tc.batch_state(scene.init_state("cpu"), 2))
    rest = {"JACOBI": "jacobi_batch", "SOR": "sor"}[solver]
    assert set(calls) == ({"substep_batch"} if admits else {"_substep_jnp", rest})


def test_masked_rounds_hand_the_solve_their_converged_scenes(monkeypatch):
    """The batched rule's solves in the outer rounds get the rounds' done
    flags (the first solve none), so a converged scene is never swept."""
    _, scene = scenes(24, 16, 2.0, 1.5, (0.6, 0.75, 0.25), substep_impl="jnp")
    seen = []
    solve = tpiso.jacobi_batch

    def spy(*a, done=None):
        seen.append(None if done is None else done.clone())
        return solve(*a, done=done)

    monkeypatch.setattr(tpiso, "jacobi_batch", spy)
    state = tc.batch_state(scene.init_state("cpu"), 3,
                           nu=torch.tensor([1e-5, 1e-3, 1e-1]))
    state, _ = tc.make_run(scene, 4)(state)
    seen.clear()
    counts = tpiso._substep_jnp(
        scene, state.u, state.v, state.p, state.p_prime, state.dt, state.nu,
        tpiso.ramped_inlet(scene.opts, state))[5]
    rounds = counts[:, 0]
    assert rounds.max() > rounds.min()  # the scenes leave the rounds apart
    # the first solve, then one a round until every scene is done (on the
    # CPU); a scene is flagged in every round after its own last one
    assert seen[0] is None and len(seen) == 1 + int(rounds.max())
    for r, d in enumerate(seen[1:]):
        assert d.tolist() == (rounds <= r).tolist(), r


def test_the_gate():
    assert kens.substep_batch_fits(tapp.ensemble_scene().grid)          # 256x96
    assert not kens.substep_batch_fits(tapp.ensemble_scene(800, 264).grid)
    assert kens.substep_batch_fits(tc.Grid(nx=241, ny=120, lx=1, ly=1))  # 28,920
    assert not kens.substep_batch_fits(tc.Grid(nx=242, ny=120, lx=1, ly=1))
    # beyond it the block form raises, as does any form of a scene no
    # cluster holds or of a SOR scene; the cluster form takes 800x264
    _, scene = scenes(800, 264, 30.0, 10.0, None)
    pp = torch.zeros(1, 264, 800)
    with pytest.raises(ValueError, match="shared memory"):
        kens.substep_batch(torch.zeros(1, 264, 801), pp, pp, pp, 0.1, 0.1, 1.0, scene,
                           form="block")
    sor = dataclasses.replace(scene, params=dataclasses.replace(
        scene.params, pressure_solver=tc.PressureSolver.SOR))
    with pytest.raises(ValueError, match="shared memory"):
        kens.substep_batch(torch.zeros(1, 264, 801), pp, pp, pp, 0.1, 0.1, 1.0, sor)
    _, wide = scenes(1100, 30, 30.0, 10.0, None)
    pp = torch.zeros(1, 30, 1100)
    with pytest.raises(ValueError, match="shared memory"):
        kens.substep_batch(torch.zeros(1, 30, 1101), pp, pp, pp, 0.1, 0.1, 1.0, wide)


def test_other_solvers_raise_naming_their_item():
    # SOR batches are ported (tests/test_torch_sor.py); FDM steps one scene
    fdm = tc.make_scene(
        tc.Grid(nx=16, ny=12, lx=1.0, ly=1.0),
        tc.SimulationParams(pressure_solver=tc.PressureSolver.FDM),
        tc.solver_options_for(tc.Semantics.RUST, early_exit=False))
    with pytest.raises(NotImplementedError, match="batched fdm.*queue 1 item 7"):
        tc.make_step(fdm)(tc.batch_state(fdm.init_state("cpu"), 2))
    # MULTIGRID steps one scene (tests/test_torch_mg_step.py); its batches wait
    mgs = tc.make_scene(
        tc.Grid(nx=16, ny=12, lx=1.0, ly=1.0),
        tc.SimulationParams(pressure_solver=tc.PressureSolver.MULTIGRID),
        tc.solver_options_for(tc.Semantics.RUST, early_exit=False))
    with pytest.raises(NotImplementedError, match="batched multigrid.*queue 1 item 9"):
        tc.make_step(mgs)(tc.batch_state(mgs.init_state("cpu"), 2))
    scene = tc.make_scene(
        tc.Grid(nx=16, ny=12, lx=1.0, ly=1.0),
        tc.SimulationParams(pressure_solver=tc.PressureSolver.MG_PRODUCTION),
        tc.solver_options_for(tc.Semantics.RUST, early_exit=False))
    with pytest.raises(NotImplementedError, match="batched mg-production.*queue 1 item 7"):
        tc.make_step(scene)(tc.batch_state(scene.init_state("cpu"), 2))


def test_app_runs_on_the_cpu(capsys):
    argv = ["--batch", "3", "--nx", "32", "--ny", "16", "--steps", "4",
            "--chunk", "2", "--device", "cpu"]
    assert tapp.main(argv) == 0
    out = capsys.readouterr().out
    assert "scene-steps/s" in out and "cell-updates/s aggregate" in out
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        tapp.main(argv + ["--shard-batch"])


@pytest.mark.parametrize("extra", [["--checkpoint", "c.npz"], ["--resume", "c.npz"],
                                   ["--autosave-every", "10"], ["--out", "runs"]])
def test_app_refuses_the_options_it_does_not_read(capsys, extra):
    with pytest.raises(SystemExit) as e:
        tapp.main(["--batch", "2", "--device", "cpu"] + extra)
    assert e.value.code == 2
    assert "no checkpoint" in capsys.readouterr().err


def test_app_is_the_jax_app():
    """The app's scene and parser are the JAX app's (apps/ensemble.py,
    apps/common.py:17-50), and so are the two ensemble cells."""
    jp, tp = jcommon.base_parser(""), tcommon.base_parser("")
    key = lambda ap: [(a.dest, a.default, a.type, a.choices) for a in ap._actions]
    assert key(jp) == key(tp)
    args = jp.parse_args(["--dt", "0.004", "--viscosity", "1e-4"])
    for nx, ny, cell in ((256, 96, "ensemble 64x256x96"),
                         (800, 264, "ensemble 8x800x264")):
        grid = jc.Grid(nx=nx, ny=ny, lx=30.0, ly=10.0,
                       obstacles=(jc.Cylinder(7.5, 5.0, 0.75),))
        want = jc.make_scene(grid, jcommon.params_from_args(args),
                             jc.solver_options_for(jc.Semantics.RUST, early_exit=False))
        make, _, _, batch = cells.CELLS[cell]
        got = make()
        for part in ("grid", "params", "opts"):
            assert repr(getattr(got, part)) == repr(getattr(want, part)), (cell, part)
        assert batch == int(cell.split()[1].split("x")[0])
    state = tapp.ensemble_state(tapp.ensemble_scene(), 64, "cpu")
    np.testing.assert_array_equal(state.nu.numpy(),
                                  np.geomspace(1e-5, 1e-2, 64).astype(np.float32))
