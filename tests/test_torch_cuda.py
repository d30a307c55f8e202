"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here needs a card and nvcc and skips without them. The file
imports no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest`` skips tests/conftest.py, which imports jax.)
"""
import dataclasses

import pytest
import torch

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.kernels import cluster as kcl
from cfd_demo_tpu_torch.kernels import ensemble as kens
from cfd_demo_tpu_torch.kernels import jacobi as kjac
from cfd_demo_tpu_torch.kernels import jacobi_batch as kjb
from cfd_demo_tpu_torch.kernels import mg as kmg
from cfd_demo_tpu_torch.kernels import mgp as kmgp
from cfd_demo_tpu_torch.kernels import rounds as krounds
from cfd_demo_tpu_torch.kernels import sor as ksor
from cfd_demo_tpu_torch.kernels import substep as ksub
from cfd_demo_tpu_torch.ops import fdm
from cfd_demo_tpu_torch.ops.poisson import _apply_pprime_bcs, _cc_prolong_x, sor
from cfd_demo_tpu_torch.apps.ensemble import ensemble_scene, ensemble_state
from cfd_demo_tpu_torch.solver import piso as tpiso

pytestmark = pytest.mark.cuda

DT, NU, INLET = 0.003, 1e-4, 1.0
GRID = tc.Grid(nx=96, ny=64, lx=3.0, ly=2.0, obstacles=(tc.Cylinder(0.8, 1.0, 0.3),))
RUST, FIRST = tc.Semantics.RUST, tc.VelocityScheme.FIRST


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def fields(seed, grid, device, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    ny, nx = grid.ny, grid.nx
    mk = lambda *shape: (scale * torch.randn(*shape, generator=g)).to(device)
    return mk(ny, nx + 1), mk(ny, nx), mk(ny, nx), mk(ny, nx)


def assert_close(got, ref, rtol=1e-6):
    ref = ref.cpu()
    atol = rtol * max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=atol)


def test_predict_div(cuda):
    u, v, _, _ = fields(0, GRID, cuda)
    got = ksub.predict_div(u, v, DT, NU, GRID, FIRST, RUST)
    ref = ksub.predict_div_plain(u.cpu(), v.cpu(), DT, NU, GRID, FIRST, RUST)
    assert_close(got[0], ref[0])
    assert_close(got[1], ref[1])
    # rhs divides u* differences by dx*dt: an ulp of u* is ~eps/(dx*dt) there
    assert_close(got[2], ref[2], rtol=1e-6 / (GRID.dx * DT))


def test_correct_bc(cuda):
    args = fields(1, GRID, cuda) + fields(2, GRID, cuda)[:2]
    rest = (DT, INLET, GRID, tc.InletProfile.UNIFORM, tc.FlowCase.CHANNEL, RUST)
    got = ksub.correct_bc(*args, *rest)
    ref = ksub.correct_bc_plain(*(a.cpu() for a in args), *rest)
    for a, b in zip(got, ref):
        assert_close(a, b)


@pytest.mark.parametrize("shape,k", [((64, 96), 5), ((37, 53), 1), ((40, 96), 16)])
def test_jacobi_fused_k(cuda, shape, k):
    ny, nx = shape
    g = torch.Generator().manual_seed(3)
    pp = _apply_pprime_bcs(0.1 * torch.randn(shape, generator=g))
    rhs = torch.randn(shape, generator=g)
    got = kjac.jacobi_fused_k(pp.to(cuda), rhs.to(cuda), 1 / nx, 1 / ny, 0.75, k)
    ref = kjac.jacobi_fused_k_plain(pp, rhs, 1 / nx, 1 / ny, 0.75, k)
    assert_close(got[0], ref[0], rtol=1e-5)
    assert_close(got[1], ref[1], rtol=1e-5)


def _rounds_scene():
    grid = tc.Grid(nx=40, ny=24, lx=3.0, ly=1.5, obstacles=(tc.Cylinder(0.9, 0.75, 0.3),))
    return tc.make_scene(grid, tc.SimulationParams(dt=0.002, viscosity=1e-4),
                         tc.solver_options_for(RUST))


def test_rounds(cuda):
    scene = _rounds_scene()
    u, v, p, rhs = fields(4, scene.grid, cuda, scale=0.1)
    args = (u, v, p, torch.zeros_like(p), 10 * rhs)
    got = krounds.solve_correct_rounds(*args, 0.002, 1.0, scene)
    ref = krounds.solve_correct_rounds_plain(*(a.cpu() for a in args), 0.002,
                                             1.0, scene)
    for name, a, b in zip(("u", "v", "p", "pp", "err"), got, ref):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=5e-5, msg=name)
    # The same exits: as many outer rounds and Jacobi sweeps.
    assert got[5].tolist() == ref[5].tolist()
    assert ref[5][0] > 0  # outer rounds ran


@pytest.mark.parametrize("route", ["rounds", "fused"])
def test_steps_match_cpu_path(cuda, route):
    """Five steps of the slice on the card and on the CPU path."""
    scene = _rounds_scene()
    if route == "fused":
        scene = dataclasses.replace(scene, opts=dataclasses.replace(
            scene.opts, substep_impl="pallas", jacobi_tol=0.0,
            outer_corrector_rounds=0, early_exit=False))
    run = tc.make_run(scene, 5)
    a, _ = run(scene.init_state(cuda))
    b, _ = run(scene.init_state("cpu"))
    for f in ("u", "v"):
        assert_close(getattr(a, f), getattr(b, f), rtol=1e-5)
    d = (a.p.cpu() - b.p).double()
    assert float((d - d.mean()).abs().max()) <= 1e-5 * max(1.0, float(b.p.abs().max()))


def test_fast_rollout_never_syncs(cuda):
    """The fixed-schedule fused rollout reads nothing back to the host."""
    grid = tc.Grid(nx=128, ny=128, lx=30.0, ly=30.0, obstacles=(tc.Cylinder(7.5, 15.0, 3.0),))
    scene = tc.make_scene(grid, tc.SimulationParams(dt=0.002, viscosity=1e-4),
                          tc.solver_options_for(
                              RUST, ramp_up_steps=10, jacobi_tol=0.0,
                              outer_corrector_rounds=0, early_exit=False,
                              substep_impl="pallas"))
    state = scene.init_state(cuda)
    state, _ = tc.make_run(scene, 2)(state)  # warm the allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = tc.make_run(scene, 3)(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(state.u).all())


def _fine(shape, seed=5):
    g = torch.Generator().manual_seed(seed)
    pp = _apply_pprime_bcs(0.1 * torch.randn(shape, generator=g))
    return pp, torch.randn(shape, generator=g), 1 / shape[1], 1 / shape[0]


def _res_tol(p, rhs, dx, dy):
    """The residual's f32 cancellation floor (tests/test_projection.py:320)."""
    eps = torch.finfo(torch.float32).eps
    return 30 * eps * ((2 / dx ** 2 + 2 / dy ** 2) * float(p.abs().max())
                       + float(rhs.abs().max()))


@pytest.mark.parametrize("shape,k,emit_res", [((64, 97), 3, True), ((37, 53), 3, False),
                                              ((40, 96), 0, True), ((128, 130), 5, True)])
def test_mgp_res(cuda, shape, k, emit_res):
    pp, rhs, dx, dy = _fine(shape)
    got = kmgp.jacobi_fused_k_res(pp.to(cuda), rhs.to(cuda), dx, dy, 0.75, k, emit_res)
    ref = kmgp.jacobi_fused_k_res_plain(pp, rhs, dx, dy, 0.75, k, emit_res)
    tol = _res_tol(ref[0], rhs, dx, dy)
    assert_close(got[0], ref[0], rtol=1e-5)
    if emit_res:
        torch.testing.assert_close(got[1].cpu(), ref[1], rtol=0, atol=tol)
    else:
        assert got[1] is None
    torch.testing.assert_close(got[2].cpu(), ref[2], rtol=1e-3, atol=tol)


@pytest.mark.parametrize("shape,k", [((64, 96), 3), ((38, 130), 4), ((40, 96), 0)])
def test_mgp_restrict_and_corr(cuda, shape, k):
    ny, nx = shape
    pp, rhs, dx, dy = _fine(shape)
    got = kmgp.jacobi_fused_k_restrict(pp.to(cuda), rhs.to(cuda), dx, dy, 0.75, k)
    ref = kmgp.jacobi_fused_k_restrict_plain(pp, rhs, dx, dy, 0.75, k)
    tol = _res_tol(ref[0], rhs, dx, dy)
    assert_close(got[0], ref[0], rtol=1e-5)
    torch.testing.assert_close(got[1].cpu(), ref[1], rtol=0, atol=tol)
    torch.testing.assert_close(got[2].cpu(), ref[2], rtol=1e-3, atol=tol)
    g = torch.Generator().manual_seed(6)
    e_c = 0.05 * torch.randn(((ny - 2) // 2, (nx - 2) // 2), generator=g)
    row = _cc_prolong_x(e_c, nx - 2).contiguous()
    got = kmgp.jacobi_fused_k_corr(ref[0].to(cuda), rhs.to(cuda), row.to(cuda),
                                   dx, dy, 0.75, k)
    ref = kmgp.jacobi_fused_k_corr_plain(ref[0], rhs, row, dx, dy, 0.75, k)
    assert_close(got[0], ref[0], rtol=1e-5)
    torch.testing.assert_close(got[1].cpu(), ref[1], rtol=1e-3,
                               atol=_res_tol(ref[0], rhs, dx, dy))
    assert float(got[2]) == float(got[0].abs().max())
    torch.testing.assert_close(got[2].cpu(), ref[2], rtol=1e-5, atol=0)


@pytest.mark.parametrize("shape", [(64, 96), (63, 97), (9, 1), (1, 9)])
@pytest.mark.parametrize("d_mult", [1.0, 1.5, 16.5 / 32])
def test_cc_sweeps(cuda, shape, d_mult):
    g = torch.Generator().manual_seed(7)
    p = 0.1 * torch.randn(shape, generator=g)
    rhs = torch.randn(shape, generator=g)
    dx, dy = 1 / max(shape), 1 / min(shape)
    for emit_res in (True, False):
        got = kmgp.cc_sweeps(p.to(cuda), rhs.to(cuda), dx, dy, 0.75, 3, d_mult * dx,
                             emit_res)
        ref = kmgp.cc_sweeps_plain(p, rhs, dx, dy, 0.75, 3, d_mult * dx, emit_res)
        torch.testing.assert_close(got[0].cpu(), ref[0], rtol=1e-5, atol=1e-5)
        if emit_res:
            torch.testing.assert_close(got[1].cpu(), ref[1], rtol=0,
                                       atol=_res_tol(ref[0], rhs, dx, dy))
        else:
            assert got[1] is None


def test_fdm_is_full_f32_whatever_the_flags(cuda):
    """The bottom solve against an f64 solve with TF32 turned on for f32
    matmuls: its products never take TF32 (ops/fdm.py)."""
    g = torch.Generator().manual_seed(8)
    r = torch.randn((64, 64), generator=g)
    args = (0.23, 0.23, 0.23 * 16.5 / 32)
    qy, qx, s = (t.double() for t in fdm._fdm_bases(64, 64, *args, torch.device("cpu")))
    want = -(qy @ ((qy.T @ r.double() @ qx) * s) @ qx.T)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")  # TF32 for f32 matmuls
        got = fdm.fdm_solve_interior(r.to(cuda), *args)
    finally:
        torch.set_float32_matmul_precision(before)
    err = float((got.cpu().double() - want).abs().max() / want.abs().max())
    assert err <= 1e-5, err  # TF32 would be ~1e-3


@pytest.mark.parametrize("nx,ny,substep_impl", [(64, 48, "pallas"), (65, 47, "auto")])
def test_production_steps_match_cpu_path(cuda, nx, ny, substep_impl):
    """Three MG_PRODUCTION steps on the card and on the CPU path: u and v
    to 1e-5, p' to its noise-floor spread (the solve amplifies rounding
    in its smoothest modes, tests/test_torch_mgp.py)."""
    grid = tc.Grid(nx=nx, ny=ny, lx=4.0 * nx / 24, ly=1.5 * ny / 16,
                   obstacles=(tc.Cylinder(1.0, 0.75 * ny / 16, 0.3),))
    scene = tc.make_scene(grid, tc.SimulationParams(
        dt=0.004, viscosity=1e-4, pressure_solver=tc.PressureSolver.MG_PRODUCTION),
        tc.solver_options_for(RUST, ramp_up_steps=2, outer_corrector_rounds=0,
                              mgp_coarse_stop=8, substep_impl=substep_impl))
    before = (kmgp.jacobi_fused_k_restrict.launches, kmgp.jacobi_fused_k_res.launches,
              kmgp.cc_sweeps.launches)
    run = tc.make_run(scene, 3)
    a, _ = run(scene.init_state(cuda))
    b, _ = run(scene.init_state("cpu"))
    after = (kmgp.jacobi_fused_k_restrict.launches, kmgp.jacobi_fused_k_res.launches,
             kmgp.cc_sweeps.launches)
    even = nx % 2 == 0 and ny % 2 == 0
    assert (after[0] > before[0]) == even and (after[1] > before[1]) != even
    assert after[2] > before[2]
    for f in ("u", "v"):
        assert_close(getattr(a, f), getattr(b, f), rtol=1e-5)
    d = (a.p_prime.cpu() - b.p_prime).double()
    assert float((d - d.mean()).abs().max()) <= 1e-3 * max(1.0, float(b.p_prime.abs().max()))


def _ensemble_scene(nx, ny):
    grid = tc.Grid(nx=nx, ny=ny, lx=3.0 * nx / 40, ly=1.5 * ny / 24,
                   obstacles=(tc.Cylinder(0.9, 0.75, 0.3),))
    return tc.make_scene(grid, tc.SimulationParams(dt=0.002, viscosity=1e-4),
                         tc.solver_options_for(RUST, early_exit=False))


def _ensemble_inputs(scene, B, seed):
    """B noisy scenes; scene 0 at rest with a zero inlet, so that its
    solve exits on its first sweep."""
    g = torch.Generator().manual_seed(seed)
    ny, nx = scene.grid.ny, scene.grid.nx
    mk = lambda s, *shape: s * torch.randn(B, *shape, generator=g)
    u, v, p = mk(0.05, ny, nx + 1), mk(0.05, ny, nx), mk(0.01, ny, nx)
    u[0], v[0], p[0] = 0.0, 0.0, 0.0
    pp = torch.zeros(B, ny, nx)
    dt = torch.full((B,), 0.002)
    nu = torch.logspace(-5, -3, B)
    inlet = torch.linspace(0.5, 1.5, B)
    inlet[0] = 0.0
    return u, v, p, pp, dt, nu, inlet


def _cluster_sizes(ny, nx):
    """Every CTAs a scene that the cluster form can split an (ny, nx)
    scene over (kernels.cluster.slab_plan)."""
    return [c for c in kcl.CTAS if kcl.slab_plan(ny, nx, c) is not None]


def _same_bits(got, ref, what):
    """Every output of two forms of a kernel equal to the bit."""
    for i, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(a, b), (what, i, float((a.double() - b.double()).abs().max()))


def _substep_forms(args, scene):
    """Kernel 20 on ``args`` (CUDA) in its block form and its cluster form
    at every C it can take: each cluster form bit for bit the block form
    (the parent form), the same counts. Returns the block form's outputs."""
    g = scene.grid
    block = kens.substep_batch(*args, scene, form="block")
    for c in _cluster_sizes(g.ny, g.nx):
        _same_bits(kens.substep_batch(*args, scene, ctas=c), block, f"{c} CTAs")
    return block


@pytest.mark.parametrize("nx,ny,B", [(40, 24, 4), (53, 37, 3)])
def test_substep_batch(cuda, nx, ny, B):
    """The whole-substep kernel against its plain version, twice (the
    second warm-started): the same exits, fields at the bound of
    tests/test_ensemble_pallas.py; the route takes the cluster form, and
    the cluster form at every C gives the block form's bits."""
    scene = _ensemble_scene(nx, ny)
    args = _ensemble_inputs(scene, B, seed=9)
    for _ in range(2):
        dev_args = tuple(a.to(cuda) for a in args)
        n_cluster = kens.substep_batch.cluster_launches
        got = kens.substep_batch(*dev_args, scene)
        assert kens.substep_batch.cluster_launches == n_cluster + 1
        ref = kens.substep_batch_plain(*args, scene)
        assert got[5].tolist() == ref[5].tolist()
        assert ref[5][0].tolist()[1] == 1  # scene 0 exits on its first sweep
        for name, a, b in zip(("u", "v", "p", "pp", "err"), got, ref):
            torch.testing.assert_close(a.cpu(), b, rtol=2e-5, atol=2e-5, msg=name)
        _same_bits(got, _substep_forms(dev_args, scene), "the route")
        args = (*ref[:4], *args[4:])


@pytest.mark.parametrize("solver", ["JACOBI", "SOR"])
def test_substep_batch_waves(cuda, solver):
    """150 distinct scenes, more than the card holds clusters of one CTA
    (132 SMs), so the batch runs in waves at every C: twice (the second
    warm-started), the block form's bits and counts at every C, and the
    batch cut into launches of 7 scenes gives the same bits (no scene
    reads another's data, in any wave). Against the plain version:
    Jacobi's exits; the fields' bound is test_substep_batch's, which the
    block form misses here in p at one scene, and SOR's exits are
    test_substep_batch_sor's, which the block form misses here by one
    iteration at two scenes whose error ends within 1.1e-7 of the
    tolerance (PERF.md: the plain version's rounding, not the
    kernels')."""
    scene = _ensemble_scene(40, 24)
    scene = dataclasses.replace(scene, params=dataclasses.replace(
        scene.params, pressure_solver=tc.PressureSolver[solver]))
    args = _ensemble_inputs(scene, 150, seed=9)
    for _ in range(2):
        dev_args = tuple(a.to(cuda) for a in args)
        n_cluster = kens.substep_batch.cluster_launches + kens.substep_batch_sor.cluster_launches
        got = kens.substep_batch(*dev_args, scene)
        assert (kens.substep_batch.cluster_launches
                + kens.substep_batch_sor.cluster_launches) == n_cluster + 1
        ref = kens.substep_batch_plain(*args, scene)
        if solver == "JACOBI":
            assert got[5].tolist() == ref[5].tolist()
        _same_bits(got, _substep_forms(dev_args, scene), "the route")
        parts = [kens.substep_batch(*(a[i:i + 7] for a in dev_args), scene)
                 for i in range(0, 150, 7)]
        _same_bits(got, [torch.cat([p[k] for p in parts]) for k in range(6)], "7 a launch")
        args = (*ref[:4], *args[4:])


def test_substep_batch_ctas_refused(cuda):
    """A C the plan cannot split the scene over raises before any launch."""
    scene = _ensemble_scene(1100, 12)  # wider than a cluster takes: the block form
    args = tuple(a.to(cuda) for a in _ensemble_inputs(scene, 2, seed=9))
    assert not kcl.cluster_fits(12, 1100)
    n = kens.substep_batch.launches
    with pytest.raises(ValueError, match="cluster"):
        kens.substep_batch(*args, scene, ctas=2)
    assert kens.substep_batch.launches == n
    n_cluster = kens.substep_batch.cluster_launches
    got = kens.substep_batch(*args, scene)
    assert kens.substep_batch.cluster_launches == n_cluster
    ref = kens.substep_batch_plain(*(a.cpu() for a in args), scene)
    assert got[5].tolist() == ref[5].tolist()


def _l2(x):
    return float(x.double().pow(2).mean().sqrt())


def _hold_substep(got, ref, scene, what):
    """Kernel 20's substep ``got`` against a plain route's ``ref``, scene
    by scene: the same outer rounds, the sweeps one a solve apart at most
    (the knife edge of ROADMAP.md section 3), and u, v, p, p' at the golden
    bound, L2 <= 1e-5 max(1, rms) (tests/test_golden.py; p and p' each
    scene's mean removed), plus what the sweeps apart allow: each moves p'
    by less than jacobi_tol in every cell, and u and v by dt 2 / h of
    that."""
    g, opts = scene.grid, scene.opts
    n, n_ref = got[5].cpu(), ref[5].cpu()
    assert n[:, 0].tolist() == n_ref[:, 0].tolist(), (what, n.tolist(), n_ref.tolist())
    apart = (n[:, 1] - n_ref[:, 1]).abs()
    assert bool((apart <= n_ref[:, 0] + 1).all()), (what, n.tolist(), n_ref.tolist())
    for b in range(n.shape[0]):
        slack_p = float(apart[b]) * opts.jacobi_tol
        slack_uv = float(scene.params.dt) * 2 * slack_p / min(g.dx, g.dy)
        for i, name in enumerate(("u", "v", "p", "pp")):
            a, r = got[i][b].cpu(), ref[i][b].cpu()
            d = a.double() - r.double()
            if name in ("p", "pp"):
                d = d - d.mean()
            bound = 1e-5 * max(1.0, _l2(r)) + (slack_p if name in ("p", "pp") else slack_uv)
            assert _l2(d) <= bound, (what, b, name, _l2(d), bound)


@pytest.mark.parametrize("nx,ny,B", [(800, 264, 8), (400, 132, 3)])
def test_substep_batch_cluster_beyond_the_block(cuda, nx, ny, B):
    """The ensemble beyond the block form's gate (the 8x800x264 batch of
    the app's viscosities after 5 steps, and 3x400x132): the batched route
    takes kernel 20's cluster form in one launch, which holds to the
    route it replaced (the plain predictor, kernel 12 and the masked
    rounds) and to the plain version (substep_batch_plain), twice (the
    second from the first's fields)."""
    scene = ensemble_scene(nx, ny)
    assert not kens.substep_batch_fits(scene.grid) and kcl.cluster_fits(ny, nx)
    assert kens.substep_batch_takes(scene, B, cuda)
    state, _ = tc.make_run(scene, 5)(ensemble_state(scene, B, cuda))
    args = (state.u, state.v, state.p, state.p_prime, state.dt, state.nu,
            tpiso.ramped_inlet(scene.opts, state))
    for _ in range(2):
        launches = (kens.substep_batch.cluster_launches, kjb.jacobi_batch.launches)
        got = tpiso._substep_batched(scene, *args)
        assert (kens.substep_batch.cluster_launches, kjb.jacobi_batch.launches) == (
            launches[0] + 1, launches[1])
        _same_bits(got, kens.substep_batch(*args, scene), "the route")
        kernel12 = tpiso._substep_jnp(scene, *args)
        assert kjb.jacobi_batch.launches > launches[1]
        _hold_substep(got, kernel12, scene, "against kernel 12's route")
        _hold_substep(got, kens.substep_batch_plain(*args, scene), scene,
                      "against the plain version")
        args = (*got[:4], *args[4:])


def test_wide_batch_keeps_kernel12(cuda):
    """A batch wider than 1024 columns, beyond the block form's gate, that
    no cluster holds: its steps launch kernel 12 and never kernel 20, and
    match the CPU path."""
    scene = _ensemble_scene(1100, 30)
    assert not kens.substep_batch_fits(scene.grid) and not kcl.cluster_fits(30, 1100)
    nu = torch.tensor([1e-4, 1e-3])
    before = (kens.substep_batch.launches, kjb.jacobi_batch.launches)
    run = tc.make_run(scene, 3)
    a, _ = run(tc.batch_state(scene.init_state(cuda), 2, nu=nu.to(cuda)))
    assert kens.substep_batch.launches == before[0]
    assert kjb.jacobi_batch.launches > before[1]
    b, _ = run(tc.batch_state(scene.init_state("cpu"), 2, nu=nu))
    for f in ("u", "v"):
        assert_close(getattr(a, f), getattr(b, f), rtol=1e-5)


def _jacobi_forms(pp, rhs, *solve, done=None):
    """Kernel 12 in its cooperative form and its cluster form at every C
    it can take: each cluster form bit for bit the cooperative form (the
    parent form). Returns the cooperative form's outputs."""
    ny, nx = pp.shape[1:]
    coop = kjb.jacobi_batch(pp, rhs, *solve, done=done, form="cooperative")
    for c in _cluster_sizes(ny, nx):
        _same_bits(kjb.jacobi_batch(pp, rhs, *solve, done=done, ctas=c), coop, f"{c} CTAs")
    return coop


# (140, 16, 24): more scenes than the card holds clusters of one CTA.
@pytest.mark.parametrize("shape,tol", [((3, 16, 24), 0.0), ((3, 37, 53), 1e-4),
                                       ((5, 64, 96), 1e-3), ((140, 16, 24), 1e-4)])
def test_jacobi_batch(cuda, shape, tol):
    g = torch.Generator().manual_seed(10)
    pp = _apply_pprime_bcs(0.1 * torch.randn(shape, generator=g))
    rhs = torch.randn(shape, generator=g)
    rhs[0] = 0.0
    pp[0] = 0.0  # scene 0 exits on its first sweep when tol > 0
    dx, dy = 1 / shape[2], 1 / shape[1]
    n_cluster = kjb.jacobi_batch.cluster_launches
    got = kjb.jacobi_batch(pp.to(cuda), rhs.to(cuda), dx, dy, 0.75, tol, 30)
    assert kjb.jacobi_batch.cluster_launches == n_cluster + 1
    ref = kjb.jacobi_batch_plain(pp, rhs, dx, dy, 0.75, tol, 30)
    assert got[2].tolist() == ref[2].tolist()
    if tol > 0:
        assert ref[2][0] == 1
    assert_close(got[0], ref[0], rtol=1e-5)
    assert_close(got[1], ref[1], rtol=1e-5)
    _same_bits(got, _jacobi_forms(pp.to(cuda), rhs.to(cuda), dx, dy, 0.75, tol, 30),
               "the route")


@pytest.mark.parametrize("shape", [(4, 16, 24), (3, 37, 53)])
def test_jacobi_batch_done_flags(cuda, shape):
    """Scenes flagged done on entry are not swept; the others run as
    without the flags; with every scene flagged the launch sweeps none."""
    g = torch.Generator().manual_seed(11)
    pp = _apply_pprime_bcs(0.1 * torch.randn(shape, generator=g))
    rhs = torch.randn(shape, generator=g)
    dx, dy = 1 / shape[2], 1 / shape[1]
    done = torch.arange(shape[0]) % 2 == 1
    for flags in (done, torch.ones_like(done)):
        got = kjb.jacobi_batch(pp.to(cuda), rhs.to(cuda), dx, dy, 0.75, 1e-4, 30,
                               done=flags.to(cuda))
        ref = kjb.jacobi_batch_plain(pp, rhs, dx, dy, 0.75, 1e-4, 30, done=flags)
        assert got[2].tolist() == ref[2].tolist()
        assert not got[2][flags.to(cuda)].any()
        assert torch.equal(got[0].cpu()[flags], pp[flags])
        assert torch.isinf(got[1].cpu()[flags]).all()
        assert_close(got[0], ref[0], rtol=1e-5)
        _same_bits(got, _jacobi_forms(pp.to(cuda), rhs.to(cuda), dx, dy, 0.75, 1e-4, 30,
                                      done=flags.to(cuda)), "the route")


@pytest.mark.parametrize("shape,k", [((64, 96), 5), ((37, 53), 1), ((40, 96), 8)])
def test_sor_fused_k(cuda, shape, k):
    """The full-layout SOR kernel (odd sizes included) against k plain
    iterations; omega = 1.7 amplifies the multipliers' ulps, hence 1e-5."""
    ny, nx = shape
    g = torch.Generator().manual_seed(12)
    pp = _apply_pprime_bcs(0.1 * torch.randn(shape, generator=g))
    rhs = torch.randn(shape, generator=g)
    pp_d = pp.to(cuda)
    got = ksor.sor_fused_k(pp_d, rhs.to(cuda), 1 / nx, 1 / ny, 1.7, k)
    ref = ksor.sor_fused_k_plain(pp, rhs, 1 / nx, 1 / ny, 1.7, k)
    assert torch.equal(pp_d.cpu(), pp)  # the caller's p' is not changed
    assert_close(got[0], ref[0], rtol=1e-5)
    assert_close(got[1], ref[1], rtol=1e-5)


@pytest.mark.parametrize("shape,k", [((64, 96), 5), ((37, 54), 3), ((40, 42), 10)])
def test_sor_fused_k_rb2(cuda, shape, k):
    """The colour-split kernel on odd heights and odd half widths."""
    ny, nx = shape
    g = torch.Generator().manual_seed(13)
    pp = _apply_pprime_bcs(0.1 * torch.randn(shape, generator=g))
    rhs = torch.randn(shape, generator=g)
    split = ksor.sor_compress(pp) + ksor.sor_compress(rhs)
    got = ksor.sor_fused_k_rb2(*(a.to(cuda) for a in split), 1 / nx, 1 / ny, 1.7, k)
    ref = ksor.sor_fused_k_rb2_plain(*split, 1 / nx, 1 / ny, 1.7, k)
    for a, b in zip(got, ref):
        assert_close(a, b, rtol=1e-5)


@pytest.mark.parametrize("tol", [0.0, 1e-30])
def test_sor_chains(cuda, tol):
    """Both chains on the card against the plain sor, 50 iterations at
    k = 8; sync debug mode "error" holds the fixed schedule to no read."""
    ny, nx = 48, 64
    g = torch.Generator().manual_seed(14)
    pp = _apply_pprime_bcs(0.1 * torch.randn((ny, nx), generator=g))
    rhs = torch.randn((ny, nx), generator=g)
    args = (1 / nx, 1 / ny, 1.7, tol, 50)
    ref = sor(pp, rhs, *args, early_exit=False)
    pp_d, rhs_d = pp.to(cuda), rhs.to(cuda)
    for chain in (ksor.sor_chain, ksor.sor_chain_rb2):
        if tol == 0.0:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = chain(pp_d, rhs_d, *args, k=8, early_exit=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert got[2] == 50
        assert_close(got[0], ref[0], rtol=1e-5)


@pytest.mark.parametrize("nx,ny,B,opts", [
    (40, 24, 4, {"outer_corrector_rounds": 0, "jacobi_tol": 0.0, "jacobi_iters": 30}),
    (53, 37, 3, {})])
def test_substep_batch_sor(cuda, nx, ny, B, opts):
    """Kernel 20's SOR form against the plain batched SOR substep, twice
    (the second warm-started): the same exits. Fields at 1e-4, the bound
    of tests/test_ensemble_pallas.py:183 for its setup (the first case:
    no rounds, tol 0, 30 iterations); with outer rounds and a live
    tolerance p' drifts by the multipliers' rounding, ~1e-6 max|p'| an
    iteration at omega = 1.7 (PERF.md), so p and p' are held to twice
    that over the iterations run, after removing each scene's mean."""
    scene = _ensemble_scene(nx, ny)
    scene = dataclasses.replace(
        scene, params=dataclasses.replace(scene.params,
                                          pressure_solver=tc.PressureSolver.SOR),
        opts=dataclasses.replace(scene.opts, **opts))
    args = _ensemble_inputs(scene, B, seed=15)
    n0 = kens.substep_batch_sor.launches
    for _ in range(2):
        n_cluster = kens.substep_batch_sor.cluster_launches
        dev_args = tuple(a.to(cuda) for a in args)
        got = kens.substep_batch(*dev_args, scene)
        assert kens.substep_batch_sor.cluster_launches == n_cluster + 1
        _same_bits(got, _substep_forms(dev_args, scene), "the route")
        ref = kens.substep_batch_plain(*args, scene)
        assert got[5].tolist() == ref[5].tolist()
        assert ref[5][0].tolist()[1] == (30 if opts else 1)  # scene 0: at rest
        fields = ("u", "v", "p", "pp", "err") if opts else ("u", "v", "err")
        for name in fields:
            i = ("u", "v", "p", "pp", "err").index(name)
            torch.testing.assert_close(got[i].cpu(), ref[i], rtol=1e-4, atol=1e-4,
                                       msg=name)
        if not opts:
            drift = 2e-6 * int(ref[5][:, 1].max())
            for name, a, b in zip(("p", "pp"), got[2:4], ref[2:4]):
                d = (a.cpu() - b).double()
                d = d - d.mean(dim=(-2, -1), keepdim=True)
                assert float(d.abs().max()) <= drift * max(1.0, float(b.abs().max())), name
        args = (*ref[:4], *args[4:])
    # the route, the block form and the cluster form at every C, twice
    assert kens.substep_batch_sor.launches == n0 + 2 * (2 + len(_cluster_sizes(ny, nx)))


# The vertex multigrid's kernels (csrc/mg.cu) on even, odd and 3-wide
# levels, and on both routes of the smoothers: 150x161 (24,150 cells) is
# above the one-block limit (csrc/mg.cu kBlockCells, 19,370), the others
# below. Tolerances as tests/test_torch_mg.py states them.
MG_SHAPES = [(64, 96), (37, 53), (3, 17), (17, 3), (150, 161)]
EPS = torch.finfo(torch.float32).eps


def _sweep_tol(k, p_ref, rhs_scaled_max):
    """16 eps k (max|p| + max|scaled rhs|): the multipliers' few ulps a
    sweep, carried by Jacobi's iteration without growth."""
    return 16 * EPS * max(k, 1) * (float(p_ref.abs().max()) + rhs_scaled_max)


@pytest.mark.parametrize("shape", MG_SHAPES)
@pytest.mark.parametrize("k", [0, 1, 5, 10])
def test_mg_smooth(cuda, shape, k):
    p, rhs, dx, dy = _fine(shape, seed=16)
    p = p + 0.05  # a boundary that the undamped sweeps must read and keep
    n0 = kmg.mg_smooth.launches
    got = kmg.mg_smooth(p.to(cuda), rhs.to(cuda), dx, dy, k)
    ref = kmg.mg_smooth_plain(p, rhs, dx, dy, k)
    assert kmg.mg_smooth.launches == n0 + (k > 0)
    br = 1 / (2 / dx ** 2 + 2 / dy ** 2)
    tol = _sweep_tol(k, ref, br * float(rhs.abs().max()))
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=tol)
    ring = torch.ones(shape, dtype=torch.bool)
    ring[1:-1, 1:-1] = False
    assert torch.equal(got.cpu()[ring], p[ring])


@pytest.mark.parametrize("shape", MG_SHAPES)
def test_mg_residual_restrict(cuda, shape):
    p, rhs, dx, dy = _fine(shape, seed=17)
    got = kmg.mg_residual_restrict(p.to(cuda), rhs.to(cuda), dx, dy)
    ref = kmg.mg_residual_restrict_plain(p, rhs, dx, dy)
    assert tuple(got.shape) == kmg.coarse_shape(*shape)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=_res_tol(p, rhs, dx, dy))


@pytest.mark.parametrize("shape", MG_SHAPES)
@pytest.mark.parametrize("bc", [False, True])
def test_mg_prolong_add(cuda, shape, bc):
    """The plain version's operations in its order: equal but for the
    last bit (1 ulp of max|out| allowed)."""
    p, _, _, _ = _fine(shape, seed=18)
    g = torch.Generator().manual_seed(19)
    e = torch.randn(kmg.coarse_shape(*shape), generator=g)
    got = kmg.mg_prolong_add(e.to(cuda), p.to(cuda), bc)
    ref = kmg.mg_prolong_add_plain(e, p, bc)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=EPS * float(ref.abs().max()))


@pytest.mark.parametrize("shape", MG_SHAPES)
@pytest.mark.parametrize("k", [0, 3, 10])
def test_mgp_smooth(cuda, shape, k):
    p, rhs, dx, dy = _fine(shape, seed=20)  # BC-consistent, as the cycle passes
    got = kmg.mgp_smooth(p.to(cuda), rhs.to(cuda), dx, dy, 0.75, k)
    ref = kmg.mgp_smooth_plain(p, rhs, dx, dy, 0.75, k)
    ar = 0.75 / (2 / dx ** 2 + 2 / dy ** 2)
    torch.testing.assert_close(got.cpu(), ref, rtol=0,
                               atol=_sweep_tol(k, ref, ar * float(rhs.abs().max())))


def _vertex_scene(nx, ny, solver, **opts):
    grid = tc.Grid(nx=nx, ny=ny, lx=30.0, ly=30.0 * ny / nx,
                   obstacles=(tc.Cylinder(7.5, 15.0 * ny / nx, 3.0),))
    return tc.make_scene(grid, tc.SimulationParams(
        dt=0.002, viscosity=1e-4, pressure_solver=getattr(tc.PressureSolver, solver)),
        tc.solver_options_for(RUST, ramp_up_steps=2, outer_corrector_rounds=0, **opts))


@pytest.mark.parametrize("nx,ny,solver", [(96, 64, "MULTIGRID"), (97, 63, "MULTIGRID"),
                                          (96, 64, "MG_PRODUCTION")])
def test_vertex_steps_match_cpu_path(cuda, nx, ny, solver):
    """Three fused-route steps on the card and on the CPU path (MULTIGRID,
    or the legacy MG_PRODUCTION cycle): u and v to 1e-5, p' to 1e-3 of
    its max after removing the mean (the legacy solve exits at its noise
    floor, tests/test_torch_mgp.py); every kernel of the cycle launched.
    The MULTIGRID run, without outer rounds, never synchronises."""
    scene = _vertex_scene(nx, ny, solver, substep_impl="pallas", mgp_scheme="legacy")
    names = ("mg_smooth", "mg_residual_restrict", "mg_prolong_add", "mgp_smooth")
    before = [getattr(kmg, n).launches for n in names]
    state = scene.init_state(cuda)
    tc.make_run(scene, 1)(state)  # warm the allocator
    torch.cuda.synchronize()
    if solver == "MULTIGRID":
        torch.cuda.set_sync_debug_mode("error")
    try:
        a, _ = tc.make_run(scene, 3)(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    b, _ = tc.make_run(scene, 3)(scene.init_state("cpu"))
    ran = {n for n, b0 in zip(names, before) if getattr(kmg, n).launches > b0}
    want = ({"mg_smooth"} if solver == "MULTIGRID" else {"mgp_smooth"})
    assert ran == want | {"mg_residual_restrict", "mg_prolong_add"}
    for f in ("u", "v"):
        assert_close(getattr(a, f), getattr(b, f), rtol=1e-5)
    d = (a.p_prime.cpu() - b.p_prime).double()
    assert float((d - d.mean()).abs().max()) <= 1e-3 * max(1e-6, float(b.p_prime.abs().max()))


# ---------------------------------------------------------------------------
# The JS twin's variants, kernel 5 and the mask hand-off
# ---------------------------------------------------------------------------

SIX = tc.Grid(nx=96, ny=64, lx=3.0, ly=2.0, obstacles=tuple(
    tc.Cylinder(0.4 + 0.45 * k, 0.6 + 0.8 * (k % 2), 0.15) for k in range(6)))


@pytest.mark.parametrize("semantics", ["RUST", "JS"])
@pytest.mark.parametrize("scheme", ["FIRST", "SECOND", "QUICK"])
def test_predict_div_variants(cuda, semantics, scheme):
    """Kernel 1's scheme and semantics forms (JS: face-position masks and
    the averaged convecting v), on six cylinders."""
    for grid in (GRID, SIX):
        u, v, _, _ = fields(10, grid, cuda)
        args = (DT, NU, grid, tc.VelocityScheme[scheme], tc.Semantics[semantics])
        got = ksub.predict_div(u, v, *args)
        ref = ksub.predict_div_plain(u.cpu(), v.cpu(), *args)
        assert_close(got[0], ref[0])
        assert_close(got[1], ref[1])
        assert_close(got[2], ref[2], rtol=1e-6 / (grid.dx * DT))


@pytest.mark.parametrize("semantics", ["RUST", "JS"])
@pytest.mark.parametrize("profile", ["PARABOLIC", "PARABOLIC_UPPER"])
def test_correct_bc_variants(cuda, semantics, profile):
    """Kernel 3's parabolic inlets (per row, in inlet_profile_traced's f32
    order) under either semantics' BC masks."""
    for grid in (GRID, SIX):
        args = fields(11, grid, cuda) + fields(12, grid, cuda)[:2]
        rest = (DT, INLET, grid, tc.InletProfile[profile], tc.FlowCase.CHANNEL,
                tc.Semantics[semantics])
        got = ksub.correct_bc(*args, *rest)
        ref = ksub.correct_bc_plain(*(a.cpu() for a in args), *rest)
        for a, b in zip(got, ref):
            assert_close(a, b)


def _js_rounds_scene(profile="PARABOLIC"):
    grid = tc.Grid(nx=40, ny=24, lx=3.0, ly=1.5, obstacles=(tc.Cylinder(0.9, 0.75, 0.3),))
    return tc.make_scene(grid, tc.SimulationParams(
        dt=0.002, viscosity=1e-4, velocity_scheme=tc.VelocityScheme.QUICK,
        inlet_profile=getattr(tc.InletProfile, profile)), tc.solver_options_for(tc.Semantics.JS))


@pytest.mark.parametrize("profile", ["PARABOLIC", "PARABOLIC_UPPER"])
def test_rounds_js(cuda, profile):
    """Kernel 4's JS form: the zero warm start, no outer rounds, the
    face-position BC masks and a parabolic inlet; the same sweeps."""
    scene = _js_rounds_scene(profile)
    u, v, p, rhs = fields(13, scene.grid, cuda, scale=0.1)
    args = (u, v, p, torch.zeros_like(p), 10 * rhs)
    got = krounds.solve_correct_rounds(*args, 0.002, 0.8, scene)
    ref = krounds.solve_correct_rounds_plain(*(a.cpu() for a in args), 0.002, 0.8, scene)
    for name, a, b in zip(("u", "v", "p", "pp", "err"), got, ref):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=5e-5, msg=name)
    assert got[5].tolist() == ref[5].tolist() and ref[5][0] == 0


@pytest.mark.parametrize("nx,ny", [(96, 64), (128, 64), (100, 88), (3, 3)])
def test_correct_div(cuda, nx, ny):
    grid = tc.Grid(nx=nx, ny=ny, lx=3.0, ly=2.0)
    args = fields(14, grid, cuda)
    before = ksub.correct_div.launches
    got = ksub.correct_div(*args, DT, grid)
    assert ksub.correct_div.launches == before + 1
    ref = ksub.correct_div_plain(*(a.cpu() for a in args), DT, grid)
    for a, b in zip(got[:3], ref[:3]):
        assert_close(a, b)
    # rhs divides corrected-u differences by dx*dt (test_predict_div)
    assert_close(got[3], ref[3], rtol=1e-6 / (min(grid.dx, grid.dy) * DT))


def _steps_match(scene, cuda, n, rtol=1e-5, start=0):
    run = tc.make_run(scene, n)
    inits = [scene.init_state(d) for d in (cuda, "cpu")]
    for init in inits:
        init.step.fill_(start)
    a, da = run(inits[0])
    b, db = run(inits[1])
    for f in ("u", "v"):
        assert_close(getattr(a, f), getattr(b, f), rtol=rtol)
    d = (a.p.cpu() - b.p).double()
    assert float((d - d.mean()).abs().max()) <= rtol * max(1.0, float(b.p.abs().max()))
    assert da.substeps.tolist() == db.substeps.tolist()


def _rounds_steps_match(monkeypatch, scene, cuda, n, start=0):
    """``_steps_match`` on the rounds route: besides the fields, kernel 1
    launched once a substep on the card, and each substep's outer rounds
    and sweeps the CPU path's, or at a float knife edge (ROADMAP queue 3)
    the rounds one apart and the sweeps one a solve apart, plus the
    extra round's solve (at most ``jacobi_iters`` sweeps) where the
    rounds differ. Each solve exits at a tolerance of its own, so each
    may meet its own knife edge: one sweep a solve is the least that
    allows that."""
    iters = scene.opts.jacobi_iters
    counts = {"cuda": [], "cpu": []}
    inner = tpiso._substep_jnp

    def kept(*args, **kwargs):
        out = inner(*args, **kwargs)
        counts[out[0].device.type].append(out[-1].tolist())
        return out

    monkeypatch.setattr(tpiso, "_substep_jnp", kept)
    before = ksub.predict_div.launches
    _steps_match(scene, cuda, n, start=start)
    assert len(counts["cuda"]) == len(counts["cpu"]) == ksub.predict_div.launches - before >= n
    for (ra, sa), (rb, sb) in zip(counts["cuda"], counts["cpu"]):
        assert abs(ra - rb) <= 1, counts
        assert abs(sa - sb) <= max(ra, rb) + 1 + abs(ra - rb) * iters, counts
    return counts["cpu"]


@pytest.mark.parametrize("route", ["rounds", "rounds-from-step-20", "fused"])
def test_six_cylinders_step_like_cpu(cuda, route, monkeypatch):
    """Six cylinders, which the kernels' old per-scene cap (four) refused:
    the rounds route (kernel 1, then kernel 4) and the fused route match
    the CPU path; from step 20 of the inlet ramp every substep after the
    first runs all 20 outer rounds."""
    opts = tc.solver_options_for(RUST)
    if route == "fused":
        opts = dataclasses.replace(opts, substep_impl="pallas", jacobi_tol=0.0,
                                   outer_corrector_rounds=0, early_exit=False)
    scene = tc.make_scene(SIX, tc.SimulationParams(dt=0.002, viscosity=1e-4), opts)
    before = (krounds.solve_correct_rounds.launches, ksub.correct_bc.launches)
    if route == "fused":
        _steps_match(scene, cuda, 5)
    else:
        start = 20 if route == "rounds-from-step-20" else 0
        counts = _rounds_steps_match(monkeypatch, scene, cuda, 5, start)
        assert (max(r for r, _ in counts) == 20) == (start == 20), counts
    after = (krounds.solve_correct_rounds.launches, ksub.correct_bc.launches)
    assert after[route == "fused"] > before[route == "fused"]


def test_six_cylinder_batch(cuda):
    """Kernel 20 reads the same masks: six cylinders, against its plain
    version."""
    scene = tc.make_scene(SIX, tc.SimulationParams(dt=0.002, viscosity=1e-4),
                          tc.solver_options_for(RUST, early_exit=False))
    args = _ensemble_inputs(scene, 3, seed=15)
    dev_args = tuple(a.to(cuda) for a in args)
    got = kens.substep_batch(*dev_args, scene)
    ref = kens.substep_batch_plain(*args, scene)
    assert got[5].tolist() == ref[5].tolist()
    for name, a, b in zip(("u", "v", "p", "pp", "err"), got, ref):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-5, atol=2e-5, msg=name)
    _same_bits(got, _substep_forms(dev_args, scene), "the route")


def test_js_adaptive_steps_like_cpu(cuda):
    """The JS twin's step (adaptive substeps, extrapolation, the rounds
    kernel from a zero p', QUICK, PARABOLIC): the same substep counts and
    fields as the CPU path."""
    scene = _js_rounds_scene()
    before = krounds.solve_correct_rounds.launches
    _steps_match(scene, cuda, 6)
    assert krounds.solve_correct_rounds.launches > before


def test_js_quick_fused_never_syncs(cuda):
    """The 2048^2 JS QUICK PARABOLIC shape, small: one pinned substep on
    the fused route reads nothing back, and matches the CPU path."""
    grid = tc.Grid(nx=128, ny=128, lx=30.0, ly=30.0, obstacles=(tc.Cylinder(7.5, 15.0, 3.0),))
    scene = tc.make_scene(grid, tc.SimulationParams(
        dt=0.002, viscosity=1e-4, velocity_scheme=tc.VelocityScheme.QUICK,
        inlet_profile=tc.InletProfile.PARABOLIC), tc.solver_options_for(
            tc.Semantics.JS, ramp_up_steps=10, jacobi_tol=0.0, jacobi_iters=50,
            outer_corrector_rounds=0, early_exit=False, substeps_adaptive=False,
            substeps_init=1, extrapolate=True, substep_impl="pallas"))
    state, _ = tc.make_run(scene, 2)(scene.init_state(cuda))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tc.make_run(scene, 3)(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _steps_match(scene, cuda, 4)


def test_rounds_impl_pallas_like_cpu(cuda):
    """rounds_impl="pallas": each outer round launches correct_div; the
    card matches the CPU path."""
    grid = tc.Grid(nx=64, ny=64, lx=30.0, ly=30.0, obstacles=(tc.Cylinder(7.5, 15.0, 3.0),))
    scene = tc.make_scene(grid, tc.SimulationParams(dt=0.002, viscosity=1e-4),
                          tc.solver_options_for(RUST, ramp_up_steps=10, rounds_impl="pallas",
                                                substep_impl="pallas"))
    before = ksub.correct_div.launches
    _steps_match(scene, cuda, 3)
    assert ksub.correct_div.launches >= before + 2 * 3


# ---------------------------------------------------------------------------
# The row-sharded tier: kernels 11 and 14, the offset forms of 1 and 3
# ---------------------------------------------------------------------------

SHARD_OFFSETS = [-16, 16, 32, 17]  # below the grid, inside, at the top, odd


def _shard_block(seed, rows, cols):
    g = torch.Generator().manual_seed(seed)
    return 0.1 * torch.randn(rows, cols, generator=g), torch.randn(rows, cols, generator=g)


@pytest.mark.parametrize("off", SHARD_OFFSETS)
@pytest.mark.parametrize("kind,k", [("jacobi", 10), ("jacobi", 3), ("sor", 5), ("sor", 2)])
def test_shard_kernels(cuda, off, kind, k):
    """Kernels 11 and 14 on a (loc + 2 halo, nx) block of a 96-row grid:
    the owned rows and err against the plain twins (the Pallas kernels'
    arithmetic, so one rounding apart)."""
    kern = kjac.jacobi_fused_k_shard if kind == "jacobi" else ksor.sor_fused_k_shard
    plain = (kjac.jacobi_fused_k_shard_plain if kind == "jacobi"
             else ksor.sor_fused_k_shard_plain)
    omega = 0.8 if kind == "jacobi" else 1.7
    halo, loc, gny, nx = 16, 48, 96, 100
    pp, rhs = _shard_block(off + k, loc + 2 * halo, nx)
    args = (off, gny, 1 / nx, 1 / gny, omega, k, halo, halo + loc)
    got = kern(pp.to(cuda), rhs.to(cuda), *args)
    ref = plain(pp, rhs, *args)
    own = slice(halo, halo + loc)
    assert_close(got[0][own], ref[0][own], rtol=1e-5)
    assert_close(got[1], ref[1], rtol=1e-5)


@pytest.mark.parametrize("kind", ["jacobi", "sor"])
@pytest.mark.parametrize("col_off", [-16, 33])
def test_shard_kernels_column_block(cuda, kind, col_off):
    kern = kjac.jacobi_fused_k_shard if kind == "jacobi" else ksor.sor_fused_k_shard
    plain = (kjac.jacobi_fused_k_shard_plain if kind == "jacobi"
             else ksor.sor_fused_k_shard_plain)
    halo, loc, gny, gnx, width = 16, 32, 96, 160, 80
    pp, rhs = _shard_block(col_off + 100, loc + 2 * halo, width)
    kw = dict(col_offset=col_off, gnx=gnx, own_cols=(halo, width - halo))
    args = (40 - halo, gny, 1 / gnx, 1 / gny, 0.8 if kind == "jacobi" else 1.7, 5,
            halo, halo + loc)
    got = kern(pp.to(cuda), rhs.to(cuda), *args, **kw)
    ref = plain(pp, rhs, *args, **kw)
    own = (slice(halo, halo + loc), slice(halo, width - halo))
    assert_close(got[0][own], ref[0][own], rtol=1e-5)
    assert_close(got[1], ref[1], rtol=1e-5)


SHARD_GRID = tc.Grid(nx=96, ny=64, lx=3.0, ly=2.0, obstacles=(tc.Cylinder(0.8, 0.6, 0.3),))


@pytest.mark.parametrize("shard", [0, 1, 3])
@pytest.mark.parametrize("scheme,semantics", [("FIRST", "RUST"), ("QUICK", "JS")])
def test_predict_div_row_offset(cuda, shard, scheme, semantics):
    """Kernel 1 on an 8-row-haloed block of one of 4 shards, the rows
    past the grid zero as the exchange gives them."""
    loc, h = 16, 8
    off = shard * loc - h
    u, v, _, _ = fields(20 + shard, SHARD_GRID, "cpu")
    u, v = (torch.nn.functional.pad(x, (0, 0, h, h))[shard * loc:shard * loc + loc + 2 * h]
            .contiguous() for x in (u, v))
    sch, sem = getattr(tc.VelocityScheme, scheme), getattr(tc.Semantics, semantics)
    got = ksub.predict_div(u.to(cuda), v.to(cuda), DT, NU, SHARD_GRID, sch, sem,
                           row_offset=off)
    ref = ksub.predict_div_plain(u, v, DT, NU, SHARD_GRID, sch, sem, row_offset=off)
    own = slice(h, h + loc)
    assert_close(got[0][own], ref[0][own])
    assert_close(got[1][own], ref[1][own])
    assert_close(got[2][own], ref[2][own], rtol=1e-4)


@pytest.mark.parametrize("shard", [0, 2, 3])
def test_correct_bc_row_offset(cuda, shard):
    loc, h = 16, 8
    off = shard * loc - h
    us, vs, p, pp, ue, ve = (
        torch.nn.functional.pad(x, (0, 0, h, h))[shard * loc:shard * loc + loc + 2 * h]
        .contiguous()
        for x in fields(30 + shard, SHARD_GRID, "cpu") + fields(40 + shard, SHARD_GRID,
                                                                 "cpu")[:2])
    args = (us, vs, p, pp, ue, ve, DT, INLET, SHARD_GRID, tc.InletProfile.PARABOLIC,
            tc.FlowCase.CHANNEL, RUST)
    kw = dict(row_offset=off, own_rows=(h, h + loc))
    got = ksub.correct_bc(*(x.to(cuda) if isinstance(x, torch.Tensor) else x
                            for x in args), **kw)
    ref = ksub.correct_bc_plain(*args, **kw)
    own = slice(h, h + loc)
    for a, b in zip(got[:3], ref[:3]):
        assert_close(a[own], b[own])
    for a, b in zip(got[3:], ref[3:]):
        assert_close(a, b)


@pytest.mark.parametrize("solver,shards", [("JACOBI", 4), ("SOR", 4), ("FDM", 2)])
def test_sharded_steps_match_cpu(cuda, solver, shards):
    """The sharded step on the card (every shard on one device) against
    the same step on the CPU, and the unsharded step on the card."""
    from cfd_demo_tpu_torch.shard import gather_state, make_mesh, make_run_shmap, shard_state
    scene = tc.make_scene(tc.Grid(nx=96, ny=128, lx=3.0, ly=4.0,
                                  obstacles=(tc.Cylinder(0.8, 2.0, 0.3),)),
                          tc.SimulationParams(dt=0.002, viscosity=1e-4,
                                              pressure_solver=getattr(tc.PressureSolver,
                                                                      solver)),
                          tc.solver_options_for(RUST, ramp_up_steps=5, jacobi_tol=0.0,
                                                jacobi_iters=20, outer_corrector_rounds=0,
                                                early_exit=False))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        mesh = make_mesh(shards, dev)
        state, _ = make_run_shmap(scene, mesh, 3)(shard_state(scene.init_state(dev), mesh))
        out[dev.type] = gather_state(state, "cpu")
    unsharded, _ = tc.make_run(scene, 3)(scene.init_state(cuda))
    for f in ("u", "v", "p"):
        assert_close(getattr(out["cuda"], f), getattr(out["cpu"], f), rtol=1e-5)
        assert_close(getattr(out["cuda"], f), getattr(unsharded, f), rtol=1e-5)


def test_sharded_fast_rollout_never_syncs(cuda):
    from cfd_demo_tpu_torch.shard import make_mesh, make_run_shmap, shard_state
    scene = tc.make_scene(tc.Grid(nx=96, ny=128, lx=3.0, ly=4.0),
                          tc.SimulationParams(dt=0.002, viscosity=1e-4),
                          tc.solver_options_for(RUST, jacobi_tol=0.0, jacobi_iters=20,
                                                outer_corrector_rounds=0,
                                                early_exit=False))
    mesh = make_mesh(4, cuda)
    state = shard_state(scene.init_state(cuda), mesh)
    run = make_run_shmap(scene, mesh, 3)
    run(state)  # builds, caches the masks
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = run(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(torch.isfinite(u).all()) for u in state.u)


# ---------------------------------------------------------------------------
# Kernel 2 tiled (t sweeps a launch in shared memory), kernel 4's two forms
# ---------------------------------------------------------------------------

TILED_SHAPES = [(3, 3), (5, 67), (67, 5), (130, 258), (257, 129), (64, 96), (40, 96),
                (2047, 2047), (2048, 2048)]


def _tiled_inputs(seed, shape):
    g = torch.Generator().manual_seed(seed)
    pp = _apply_pprime_bcs(0.1 * torch.randn(shape, generator=g))
    return pp, torch.randn(shape, generator=g)


# k as a function of the kernel's sweeps a launch t
TILED_KS = {"1": lambda t: 1, "t-1": lambda t: t - 1, "t": lambda t: t,
            "t+1": lambda t: t + 1, "16": lambda t: 16}


@pytest.mark.parametrize("k", list(TILED_KS))
@pytest.mark.parametrize("shape", TILED_SHAPES)
def test_jacobi_fused_k_tiled_bit_for_bit(cuda, shape, k):
    """Kernel 2 (t sweeps a launch on tiles in shared memory) equals the
    whole field's jacobi_fused_k_shard_plain (the Pallas kernel's
    arithmetic) to the bit, p' and err."""
    k = TILED_KS[k](kjac.jacobi_tile()["sweeps"])
    ny, nx = shape
    pp, rhs = _tiled_inputs(ny + nx + k, shape)
    got = kjac.jacobi_fused_k(pp.to(cuda), rhs.to(cuda), 1 / nx, 1 / ny, 0.75, k)
    ref = kjac.jacobi_fused_k_shard_plain(pp, rhs, 0, ny, 1 / nx, 1 / ny, 0.75, k, 0, ny)
    assert torch.equal(got[0].cpu(), ref[0]), float((got[0].cpu() - ref[0]).abs().max())
    assert torch.equal(got[1].cpu(), ref[1]), (float(got[1]), float(ref[1]))


@pytest.mark.parametrize("shape", [(130, 258), (2048, 2048)])
def test_jacobi_chain_tiled_bit_for_bit(cuda, shape):
    """50 sweeps through jacobi_chain (launches of 16 and a remainder of
    2, no tolerance) equal 50 sweeps of the plain twin."""
    ny, nx = shape
    pp, rhs = _tiled_inputs(5, shape)
    got = kjac.jacobi_chain(pp.to(cuda), rhs.to(cuda), 1 / nx, 1 / ny, 0.75, 0.0, 50)
    ref = kjac.jacobi_fused_k_shard_plain(pp, rhs, 0, ny, 1 / nx, 1 / ny, 0.75, 50, 0, ny)
    assert got[2] == 50
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1])


@pytest.mark.parametrize("tol", [1e9, 1e-9, "second"])
def test_jacobi_chain_reads_ahead_as_the_loop_that_reads_first(cuda, tol):
    """Under a tolerance the chain starts each chunk's read, queues the
    next launch and then waits (trace.read_soon): the p', error and
    sweeps of the loop that reads with .item() before it launches, at
    an exit after the first chunk, after the second and at the cap, and
    one host read a chunk run; a started read gives .item()'s value."""
    from cfd_demo_tpu_torch import trace
    ny, nx = 258, 130
    pp, rhs = _tiled_inputs(7, (ny, nx))
    pp, rhs = pp.to(cuda), rhs.to(cuda)
    dx, dy = 1 / nx, 1 / ny
    errs, want = [], pp
    for _ in range(3):
        want, e = kjac.jacobi_fused_k(want, rhs, dx, dy, 0.75, 16)
        errs.append(e.item())
    if tol == "second":
        assert errs[1] < errs[0]
        tol = (errs[0] + errs[1]) / 2
    want, chunks = pp, 0
    for _ in range(3):
        want, werr = kjac.jacobi_fused_k(want, rhs, dx, dy, 0.75, 16)
        chunks += 1
        if not (werr >= tol).item():
            break
    want, werr = kjac.jacobi_fused_k(want, rhs, dx, dy, 0.75, 2)
    before = trace.host_reads
    got, err, n = kjac.jacobi_chain(pp, rhs, dx, dy, 0.75, tol, 50)
    assert trace.host_reads - before == chunks
    assert n == 16 * chunks + 2
    assert torch.equal(got, want) and torch.equal(err, werr)
    for value in (True, False):
        started = trace.read_soon(torch.tensor(value, device=cuda))
        assert isinstance(started, trace.Soon)
        assert trace.read_host(started) is value


@pytest.mark.parametrize("n", [256, 512])
def test_round_glue_graphs_equal_the_plain_glue(cuda, n, monkeypatch):
    """bench.py --mode reference's schedule on the fused route at n^2:
    the host-read round loop with its corrector and divergence replayed
    as CUDA graphs (piso._RoundGlue) and with the plain calls give the
    same bits in every field over 12 steps from rest, the rounds
    running; a step's fields are copies, which later steps leave as they
    were."""
    from cfd_demo_tpu_torch.cells import reference_mode_scene
    scene = reference_mode_scene(n)
    scene = dataclasses.replace(scene, opts=dataclasses.replace(
        scene.opts, substep_impl="pallas"))
    init = scene.init_state(cuda)
    step = tc.make_step(scene)
    from cfd_demo_tpu_torch import trace
    rounds0 = trace.outer_rounds
    graphs, kept = [], []
    state = init
    for _ in range(12):
        state, _ = step(state)
        graphs.append(state)
        kept.append(state.u.clone())
    assert tpiso._GLUE and trace.outer_rounds > rounds0
    monkeypatch.setattr(tpiso, "_round_glue", lambda *a: None)
    state = init
    for i in range(12):
        state, _ = step(state)
        for f in ("u", "v", "p", "p_prime", "dt", "res_p"):
            assert torch.equal(getattr(graphs[i], f), getattr(state, f)), (i, f)
        assert torch.equal(graphs[i].u, kept[i])


def _rounds_state(which, cuda):
    from cfd_demo_tpu_torch.cells import cavity_scene, reference_scene, rounds_args
    if which == "800x264":
        scene, steps = reference_scene(), 55
        init = scene.init_state(cuda)
    elif which == "1024^2 cavity":  # the cavity app's constants, as chip_smoke.py's phase 3
        scene, steps = cavity_scene(1024), 20
        init = scene.init_state(cuda)
    else:  # the JS twin's grid, QUICK faces, the PARABOLIC inlet
        scene = tc.make_scene(tc.default_js_grid(), tc.SimulationParams(
            dt=0.005, viscosity=1e-6, velocity_scheme=tc.VelocityScheme.QUICK,
            inlet_profile=tc.InletProfile.PARABOLIC),
            tc.solver_options_for(tc.Semantics.JS))
        steps = 20
        init = scene.init_state(cuda)
        init.step.fill_(500)
    state, _ = tc.make_run(scene, steps)(init)
    return rounds_args(scene, state)


@pytest.mark.parametrize("which", ["800x264", "400x132 js parabolic"])
def test_rounds_cluster_equals_cooperative(cuda, which):
    """Kernel 4's cluster and cooperative forms on the same inputs: the
    same counts, the same bits in u, v, p, p' and err, at every C the
    cluster form can split the grid over; the call without a form takes
    the cluster form at the C kernels.cluster picks for both shapes."""
    args = _rounds_state(which, cuda)
    g = args[-1].grid
    b = krounds.solve_correct_rounds(*args, form="cooperative")
    for ctas in [None, *_cluster_sizes(g.ny, g.nx)]:
        a = krounds.solve_correct_rounds(*args, form="cluster", ctas=ctas)
        assert a[5].tolist() == b[5].tolist(), ctas
        for name, x, y in zip(("u", "v", "p", "pp", "err"), a, b):
            assert torch.equal(x, y), (ctas, name, float((x - y).abs().max()))
    n_cluster = krounds.solve_correct_rounds.cluster_launches
    c = krounds.solve_correct_rounds(*args)
    assert krounds.solve_correct_rounds.cluster_launches == n_cluster + 1
    assert torch.equal(c[3], b[3])
    assert kcl.plan("rounds", 1, g.ny, g.nx, cuda).ctas in kcl.candidates(g.ny, g.nx)


def test_rounds_cooperative_where_the_rule_refuses(cuda):
    """A grid past the cluster form's capacity: the cooperative form held
    against the plain version with the same counts, and the route's slab
    form against the cooperative form bit for bit."""
    grid = tc.Grid(nx=1024, ny=512, lx=8.0, ly=4.0,
                   obstacles=(tc.Cylinder(2.0, 2.0, 0.3),))
    assert kcl.plan("rounds", 1, grid.ny, grid.nx, cuda).form == "slab"
    scene = tc.make_scene(grid, tc.SimulationParams(dt=0.002, viscosity=1e-4),
                          tc.solver_options_for(RUST, jacobi_iters=40,
                                                outer_corrector_rounds=3))
    u, v, p, rhs = fields(21, grid, cuda, scale=0.1)
    args = (u, v, p, torch.zeros_like(p), 1000 * rhs)  # every solve runs its 40 sweeps
    n_cluster = krounds.solve_correct_rounds.cluster_launches
    n_slab = krounds.solve_correct_rounds.slab_launches
    got = krounds.solve_correct_rounds(*args, 0.002, 1.0, scene, form="cooperative")
    slab = krounds.solve_correct_rounds(*args, 0.002, 1.0, scene)
    assert krounds.solve_correct_rounds.cluster_launches == n_cluster
    assert krounds.solve_correct_rounds.slab_launches == n_slab + 1
    assert slab[5].tolist() == got[5].tolist()
    for name, x, y in zip(("u", "v", "p", "pp", "err"), slab, got):
        assert torch.equal(x, y), (name, float((x - y).abs().max()))
    ref = krounds.solve_correct_rounds_plain(*(a.cpu() for a in args), 0.002, 1.0, scene)
    for name, a, b in zip(("u", "v"), got, ref):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=5e-5, msg=name)
    # p and p' as chip_smoke.py holds the rounds kernel: the kernel's folded
    # multipliers move p' in its last bits a sweep, mostly along the
    # near-uniform mode, so the mean difference is removed
    for name, a, b in zip(("p", "pp"), got[2:4], ref[2:4]):
        d = a.cpu() - b
        assert float((d - d.mean()).abs().max()) <= 1e-4 * float(b.abs().max()), name
    assert float(got[4]) == pytest.approx(float(ref[4]), rel=1e-2)
    assert got[5].tolist() == ref[5].tolist() == [3, 160]
    with pytest.raises(ValueError, match="cluster form"):
        krounds.solve_correct_rounds(*args, 0.002, 1.0, scene, form="cluster")


@pytest.mark.parametrize("which", ["1024^2 cavity", "800x264", "400x132 js parabolic"])
def test_rounds_slab_equals_cooperative(cuda, which):
    """Kernel 4's slab form and its cooperative form on the same inputs:
    the same counts, the same bits in u, v, p, p' and err. The call
    without a form takes the slab form at 1024^2, where no cluster holds
    the grid, and the cluster form at 800x264 and 400x132."""
    args = _rounds_state(which, cuda)
    g = args[-1].grid
    b = krounds.solve_correct_rounds(*args, form="cooperative")
    a = krounds.solve_correct_rounds(*args, form="slab")
    assert a[5].tolist() == b[5].tolist()
    for name, x, y in zip(("u", "v", "p", "pp", "err"), a, b):
        assert torch.equal(x, y), (name, float((x - y).abs().max()))
    launches = lambda: (krounds.solve_correct_rounds.cluster_launches,
                        krounds.solve_correct_rounds.slab_launches)
    before = launches()
    c = krounds.solve_correct_rounds(*args)
    slab = which == "1024^2 cavity"
    assert launches() == (before[0] + (not slab), before[1] + slab)
    assert torch.equal(c[3], b[3])
    assert kcl.plan("rounds", 1, g.ny, g.nx, cuda, cavity=slab).form == (
        "slab" if slab else "cluster")
    assert kcl.plan("rounds", 1, g.ny, g.nx, cuda, form="slab").slab is not None


@pytest.mark.parametrize("cavity", [False, True], ids=["channel", "cavity"])
@pytest.mark.parametrize("ny,nx", [
    (1001, 1024),   # 2-row strips on 132 SMs, a last slab of one row
    (1320, 1024),   # 3-row strips
    (2000, 1024),   # 4-row strips
    (3000, 1024),   # 6-row strips, rhs from L2
    (130, 1023),    # one row a block, nx - 1 a multiple of 4
    (300, 517),
])
def test_rounds_slab_plans(cuda, cavity, ny, nx):
    """The slab form at strips of every height, with and without ar * rhs
    on chip, and a short last slab: bit for bit the cooperative form,
    the same counts, every solve at its 40 sweeps and all 3 outer rounds
    (both tolerances 0)."""
    plan = kcl.plan("rounds", 1, ny, nx, cuda, cavity=cavity, form="slab").slab
    assert plan is not None
    opts = dict(jacobi_iters=40, outer_corrector_rounds=3, jacobi_tol=0.0,
                outer_corrector_tol=0.0)
    if cavity:
        scene = _cavity_rounds_scene(ny, nx, 2, **opts)
    else:
        grid = tc.Grid(nx=nx, ny=ny, lx=3.0 * nx / ny, ly=3.0,
                       obstacles=(tc.Cylinder(1.0, 1.5, 0.3),))
        scene = tc.make_scene(grid, tc.SimulationParams(dt=0.002, viscosity=1e-4),
                              tc.solver_options_for(RUST, **opts))
    u, v, p, rhs = fields(ny + nx, scene.grid, cuda, scale=0.1)
    pp0 = 0.01 * _cavity_pp(5, (ny, nx))[0].to(cuda) if cavity else torch.zeros_like(p)
    args = (u, v, p, pp0, 1000 * rhs, 0.002, 1.0, scene)
    b = krounds.solve_correct_rounds(*args, form="cooperative")
    a = krounds.solve_correct_rounds(*args, form="slab")
    assert a[5].tolist() == b[5].tolist() == [3, 160], plan
    for name, x, y in zip(("u", "v", "p", "pp", "err"), a, b):
        assert torch.equal(x, y), (plan, name, float((x - y).abs().max()))


def test_rounds_slab_refused(cuda):
    """The slab form asked for where its plan does not take the grid (more
    than 1024 columns), or with a cluster's CTAs, raises before a launch."""
    scene = _cavity_rounds_scene(24, 1100)
    u, v, p, rhs = fields(3, scene.grid, cuda, scale=0.1)
    n = krounds.solve_correct_rounds.launches
    with pytest.raises(ValueError, match="slab form cannot take"):
        krounds.solve_correct_rounds(u, v, p, torch.zeros_like(p), rhs, 0.002, 1.0, scene,
                                     form="slab")
    scene = _cavity_rounds_scene(24, 40)
    u, v, p, rhs = fields(3, scene.grid, cuda, scale=0.1)
    with pytest.raises(ValueError, match="slab form cannot take"):
        krounds.solve_correct_rounds(u, v, p, torch.zeros_like(p), rhs, 0.002, 1.0, scene,
                                     form="slab", ctas=1)
    assert krounds.solve_correct_rounds.launches == n


def _slab_edge_args(cuda, ny, nx, cavity, **opts):
    """Seeded inputs and a scene for the slab form's speculation tests:
    the cavity from a seeded p' (``_cavity_rounds_scene``), the channel
    from rest, an rhs that takes every solve past its first sweeps."""
    if cavity:
        scene = _cavity_rounds_scene(ny, nx, 2, **opts)
    else:
        grid = tc.Grid(nx=nx, ny=ny, lx=3.0 * nx / ny, ly=3.0,
                       obstacles=(tc.Cylinder(1.0, 1.5, 0.3),))
        scene = tc.make_scene(grid, tc.SimulationParams(dt=0.002, viscosity=1e-4),
                              tc.solver_options_for(RUST, **opts))
    u, v, p, rhs = fields(ny + nx + 7, scene.grid, cuda, scale=0.1)
    pp0 = 0.01 * _cavity_pp(5, (ny, nx))[0].to(cuda) if cavity else torch.zeros_like(p)
    return (u, v, p, pp0, 1000 * rhs, 0.002, 1.0, scene)


def _slab_dropped(args, monkeypatch, **kw):
    """The slab form's outputs and the sweeps it dropped, the count the
    wrapper keeps in ``trace.dropped`` while a profiler records."""
    from torch.profiler import ProfilerActivity, profile
    from cfd_demo_tpu_torch import trace
    monkeypatch.setattr(trace, "dropped", [])
    with profile(activities=[ProfilerActivity.CPU]):
        out = krounds.solve_correct_rounds(*args, form="slab", **kw)
    assert len(trace.dropped) == 1 and trace.dropped[0].dtype == torch.int32
    return out, trace.dropped_total(trace.dropped)


def _first_solve_errs(args, iters):
    """err after k = 1 .. iters sweeps of the first solve alone (no outer
    round, tolerance 0), from the cooperative form."""
    scene = args[-1]
    errs = []
    for k in range(1, iters + 1):
        s = dataclasses.replace(scene, opts=dataclasses.replace(
            scene.opts, jacobi_iters=k, jacobi_tol=0.0, outer_corrector_rounds=0))
        errs.append(float(krounds.solve_correct_rounds(*args[:-1], s, form="cooperative")[4]))
    return errs


# case: (solver options, outer rounds run, sweeps of each solve or None,
# dropped sweeps or None); "tol" is picked from the first solve's errs
SLAB_EDGES = {
    "tol met at the first sweep": (
        dict(jacobi_iters=12, jacobi_tol=1e30, outer_corrector_rounds=3,
             outer_corrector_tol=0.0), 3, 1, 4),
    "cap in every solve": (
        dict(jacobi_iters=12, jacobi_tol=0.0, outer_corrector_rounds=3,
             outer_corrector_tol=0.0), 3, 12, 0),
    "one sweep a solve": (
        dict(jacobi_iters=1, jacobi_tol=1e30, outer_corrector_rounds=2,
             outer_corrector_tol=0.0), 2, 1, 0),
    "exit at sweep iters - 2": (
        dict(jacobi_iters=12, jacobi_tol="tol", outer_corrector_rounds=0), 0, 11, 1),
    "exit at sweep iters - 1": (
        dict(jacobi_iters=12, jacobi_tol="tol", outer_corrector_rounds=0), 0, 12, 0),
    "0 outer rounds": (dict(outer_corrector_rounds=0), 0, None, None),
}


@pytest.mark.parametrize("case", list(SLAB_EDGES))
@pytest.mark.parametrize("ny,nx,cavity", [
    (1024, 1024, True),    # the cavity cell's plan: 2-row strips
    (1001, 1024, False),   # a last slab of one row
    (1320, 1024, True),    # 3-row strips: a row only registers hold
    (3000, 1024, False),   # 6-row strips, rhs from L2
], ids=["1024^2 cavity", "1001x1024 channel", "1320x1024 cavity", "3000x1024 channel"])
def test_rounds_slab_speculation_edges(cuda, monkeypatch, case, ny, nx, cavity):
    """The slab form's exits at the edges of its speculation (the sweep
    after the one that meets the tolerance runs before that sweep's max is
    known, and is dropped): bit for bit the cooperative form in u, v, p,
    p' and err, the same counts, and the dropped-sweep counter: one for
    each solve that met its tolerance before the cap, none for a solve
    that hit it."""
    opts, rounds, sweeps, dropped = SLAB_EDGES[case]
    opts = dict(opts)
    if opts.get("jacobi_tol") == "tol":
        # a tolerance the first solve's err crosses after exactly `sweeps` sweeps
        errs = _first_solve_errs(_slab_edge_args(cuda, ny, nx, cavity), opts["jacobi_iters"])
        assert errs[sweeps - 1] < min(errs[:sweeps - 1]), errs
        opts["jacobi_tol"] = min(errs[:sweeps - 1])
    args = _slab_edge_args(cuda, ny, nx, cavity, **opts)
    assert kcl.plan("rounds", 1, ny, nx, cuda, cavity=cavity, form="slab").slab is not None
    b = krounds.solve_correct_rounds(*args, form="cooperative")
    a, n_dropped = _slab_dropped(args, monkeypatch)
    assert a[5].tolist() == b[5].tolist(), (a[5].tolist(), b[5].tolist())
    for name, x, y in zip(("u", "v", "p", "pp", "err"), a, b):
        assert torch.equal(x, y), (name, float((x - y).abs().max()))
    got_rounds, got_sweeps = b[5].tolist()
    assert got_rounds == rounds
    iters = args[-1].opts.jacobi_iters
    if sweeps is not None:
        assert got_sweeps == (rounds + 1) * sweeps
        assert n_dropped == dropped
    else:  # one solve: it drops a sweep exactly where it exits before the cap
        assert n_dropped == int(got_sweeps < iters)


def test_rounds_slab_repeats_its_bits(cuda):
    """The slab form launched 200 times on one 1024^2 cavity state: the
    same bits in every output each time (a race in the handoffs or the
    split-phase max would show as a launch that differs)."""
    args = _rounds_state("1024^2 cavity", cuda)
    first = krounds.solve_correct_rounds(*args, form="slab")
    assert first[5].tolist()[1] > 100  # many solves, many exits
    differ = []
    for k in range(200):
        again = krounds.solve_correct_rounds(*args, form="slab")
        same = all(bool(torch.equal(x, y)) for x, y in zip(again, first))
        if not same:
            differ.append(k)
    assert differ == []


# ---------------------------------------------------------------------------
# Kernels 1 and 3 against their plain versions bit for bit
# ---------------------------------------------------------------------------

# (nx, ny): odd and even, a one-tile grid, tiles straddling every edge,
# and grids large enough for interior tiles.
TILE_SHAPES = [(65, 47), (64, 48), (33, 17), (20, 12), (130, 97), (200, 160)]
SIX_INSTANCES = [(s, m) for s in ("FIRST", "SECOND", "QUICK") for m in ("RUST", "JS")]


def _tile_grid(nx, ny, six=False):
    lx, ly = 3.0, 3.0 * ny / nx
    obstacles = (tuple(tc.Cylinder(lx * (0.15 + 0.12 * k), ly * (0.3 + 0.4 * (k % 2)),
                                   0.05 * ly) for k in range(6))
                 if six else (tc.Cylinder(0.3 * lx, 0.5 * ly, 0.2 * ly),))
    return tc.Grid(nx=nx, ny=ny, lx=lx, ly=ly, obstacles=obstacles)


def _cpu(args):
    return [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]


def _predict_bits(u, v, grid, scheme, semantics, what, **kw):
    """predict_div on the card, one launch, and the bits of predict_div_plain
    on the CPU (the kernel keeps the plain version's operand order under
    -fmad=false; PyTorch's CUDA ops do not give those bits)."""
    args = (u, v, DT, NU, grid, tc.VelocityScheme[scheme], tc.Semantics[semantics])
    n = ksub.predict_div.launches
    got = ksub.predict_div(*args, **kw)
    assert ksub.predict_div.launches == n + 1
    _same_bits([x.cpu() for x in got], ksub.predict_div_plain(*_cpu(args), **kw), what)


@pytest.mark.parametrize("scheme,semantics", SIX_INSTANCES)
@pytest.mark.parametrize("nx,ny", TILE_SHAPES)
def test_predict_div_is_plain_bit_for_bit(cuda, nx, ny, scheme, semantics):
    """The tiled predict_div gives the plain version's bits on every
    instance, one cylinder and six, and on a flow at rest."""
    for six in (False, True):
        grid = _tile_grid(nx, ny, six)
        u, v, _, _ = fields(50 + nx + ny, grid, cuda)
        _predict_bits(u, v, grid, scheme, semantics, f"predict_div {nx}x{ny} six={six}")
        _predict_bits(torch.zeros_like(u), torch.zeros_like(v), grid, scheme, semantics,
                      f"predict_div {nx}x{ny} six={six} at rest")


@pytest.mark.parametrize("scheme,semantics", SIX_INSTANCES)
@pytest.mark.parametrize("off", [-16, 16, 61, 88])
def test_predict_div_row_offset_bit_for_bit(cuda, off, scheme, semantics):
    """Row blocks of a 200x160 grid at negative and positive offsets (the
    top one past the grid), 96 rows: interior tiles at an offset, the
    whole block the plain version's bits."""
    grid = _tile_grid(200, 160)
    rows = 96
    u, v, _, _ = fields(60 + off, grid, "cpu")
    u, v = (torch.nn.functional.pad(x, (0, 0, 16, 16))[off + 16:off + 16 + rows]
            .contiguous().to(cuda) for x in (u, v))
    _predict_bits(u, v, grid, scheme, semantics, f"predict_div row_offset {off}",
                  row_offset=off)
    plan = ksub.predict_tile_plan(rows, grid.nx, tc.VelocityScheme[scheme], off, grid.ny)
    assert plan["fast"][1] > plan["fast"][0]


def _correct_inputs(seed, grid, device):
    return fields(seed, grid, device) + fields(seed + 1, grid, device)[:2]


def _correct_bits(args, rest, what, **kw):
    """correct_bc on the card, one launch, and the bits of correct_bc_plain
    on the CPU: u, v, p and the three maxima."""
    n = ksub.correct_bc.launches
    got = ksub.correct_bc(*args, *rest, **kw)
    assert ksub.correct_bc.launches == n + 1
    _same_bits([x.cpu() for x in got], ksub.correct_bc_plain(*_cpu(args), *rest, **kw), what)
    return got


@pytest.mark.parametrize("semantics", ["RUST", "JS"])
@pytest.mark.parametrize("profile", ["UNIFORM", "PARABOLIC", "PARABOLIC_UPPER"])
@pytest.mark.parametrize("nx,ny", TILE_SHAPES)
def test_correct_bc_is_plain_bit_for_bit(cuda, nx, ny, profile, semantics):
    """The one-launch correct_bc gives the plain version's bits on u, v, p
    and the three maxima, and the plan's CTA count is the kernel's."""
    grid = _tile_grid(nx, ny, six=True)
    rest = (DT, INLET, grid, tc.InletProfile[profile], tc.FlowCase.CHANNEL,
            tc.Semantics[semantics])
    _correct_bits(_correct_inputs(70 + nx, grid, cuda), rest, f"correct_bc {nx}x{ny}")
    lib = ksub.load()
    assert (lib.cfd_correct_bc_fused_partials(ny, nx)
            == ksub.correct_strip_plan(ny, nx)["partials"])


@pytest.mark.parametrize("own", [(16, 80), (0, 96), (1, 2), (63, 95)])
@pytest.mark.parametrize("off", [-16, 40, 80])
def test_correct_bc_owned_rows_bit_for_bit(cuda, off, own):
    """Owned-row windows of a row block: only they enter the maxima. The
    rows the sharded step keeps (in the grid, past the block's first row,
    whose v reads a p' row from beyond the block) are the plain version's
    bits; the maxima are those of the kernel's own fields over the owned
    rows, and the plain version's where those rows lie in the grid."""
    grid = _tile_grid(200, 160)
    rows = 96
    args = tuple(torch.nn.functional.pad(x, (0, 0, 16, 16))[off + 16:off + 16 + rows]
                 .contiguous().to(cuda) for x in _correct_inputs(80 + off, grid, "cpu"))
    rest = (DT, INLET, grid, tc.InletProfile.PARABOLIC, tc.FlowCase.CHANNEL, RUST)
    kw = dict(row_offset=off, own_rows=own)
    got = [x.cpu() for x in ksub.correct_bc(*args, *rest, **kw)]
    ref = ksub.correct_bc_plain(*_cpu(args), *rest, **kw)
    kept = slice(max(1, -off), min(rows, grid.ny - off))
    _same_bits([a[kept] for a in got[:3]], [b[kept] for b in ref[:3]], f"rows {kept}")
    lo, hi = own
    ue, ve = (a.cpu()[lo:hi] for a in args[4:6])
    u, v = got[0][lo:hi], got[1][lo:hi]
    _same_bits(got[3:], [(u - ue).abs().max(), (v - ve).abs().max(),
                         torch.maximum(u.abs().max(), v.abs().max())], "own maxima")
    if lo + off >= 0 and hi + off <= grid.ny:
        _same_bits(got[3:], ref[3:], f"maxima row_offset {off} own {own}")


@pytest.mark.parametrize("field", ["u_star", "v_star"])
def test_correct_bc_nan_comes_out(cuda, field):
    """A NaN in u* comes out in res_u and max_vel, one in v* in res_v and
    max_vel, as pmax (and torch.amax) give it; the other residual stays a
    number."""
    grid = _tile_grid(200, 160)
    args = list(_correct_inputs(90, grid, cuda))
    k = ("u_star", "v_star").index(field)
    args[k][77, 101] = float("nan")
    rest = (DT, INLET, grid, tc.InletProfile.UNIFORM, tc.FlowCase.CHANNEL, RUST)
    got = ksub.correct_bc(*args, *rest)
    assert torch.isnan(got[3 + k]) and torch.isnan(got[5]) and not torch.isnan(got[4 - k])
    ref = ksub.correct_bc_plain(*_cpu(args), *rest)
    assert torch.isnan(ref[3 + k]) and torch.isnan(ref[5]) and not torch.isnan(ref[4 - k])


def test_correct_bc_ticket_resets(cuda):
    """Calls in a row (the same shape and stream: the same partials and
    counter) give the same result; a smaller maximum after a larger one
    comes out, so no stale partial survives."""
    grid = _tile_grid(200, 160)
    rest = (DT, INLET, grid, tc.InletProfile.UNIFORM, tc.FlowCase.CHANNEL, RUST)
    big = _correct_inputs(91, grid, cuda)
    small = tuple(0.01 * x for x in big)
    first = ksub.correct_bc(*big, *rest)
    second = ksub.correct_bc(*big, *rest)
    _same_bits(first, second, "two calls")
    third = _correct_bits(small, rest, "after a larger")
    assert float(third[5]) < float(first[5])


# ---------------------------------------------------------------------------
# CAVITY flow: kernels 2, 3 and 4's cavity instances, and the cavity's steps
# ---------------------------------------------------------------------------

CAVITY = tc.FlowCase.CAVITY
# nx of every residue mod 4: kernel 4's cluster form mirrors column nx-2
# into nx-1 within a float4, or (nx - 1) % 4 == 0 folds E from the .w
CAVITY_SHAPES = [(24, 40), (24, 41), (24, 42), (24, 43), (37, 53), (64, 96)]


def _cavity_grid(ny, nx, cylinders=1):
    lx, ly = nx / ny, 1.0
    obstacles = tuple(tc.Cylinder(lx * (0.25 + 0.5 * k / max(cylinders - 1, 1)),
                                  0.3 + 0.4 * (k % 2), 0.12) for k in range(cylinders))
    return tc.Grid(nx=nx, ny=ny, lx=lx, ly=ly, obstacles=obstacles)


def _cavity_pp(seed, shape):
    from cfd_demo_tpu_torch.ops.poisson import _apply_pprime_bcs_cavity
    g = torch.Generator().manual_seed(seed)
    pp = _apply_pprime_bcs_cavity(0.1 * torch.randn(shape, generator=g))
    return pp, torch.randn(shape, generator=g)


@pytest.mark.parametrize("k", ["1", "t", "t+1", "16"])
@pytest.mark.parametrize("shape", [*CAVITY_SHAPES, (3, 3), (130, 258), (2048, 2048)])
def test_jacobi_fused_k_cavity_bit_for_bit(cuda, shape, k):
    """Kernel 2's CAVITY instance equals the whole field's folded twin
    with the cavity BCs bit for bit, and the plain sweeps within the
    channel form's tolerance."""
    k = TILED_KS[k](kjac.jacobi_tile()["sweeps"])
    ny, nx = shape
    pp, rhs = _cavity_pp(ny + nx + k, shape)
    n = kjac.jacobi_fused_k.cavity_launches
    got = kjac.jacobi_fused_k(pp.to(cuda), rhs.to(cuda), 1 / nx, 1 / ny, 0.75, k, cavity=True)
    assert kjac.jacobi_fused_k.cavity_launches == n + 1
    ref = kjac.jacobi_fused_k_folded(pp, rhs, 1 / nx, 1 / ny, 0.75, k, cavity=True)
    assert torch.equal(got[0].cpu(), ref[0]), float((got[0].cpu() - ref[0]).abs().max())
    assert torch.equal(got[1].cpu(), ref[1]), (float(got[1]), float(ref[1]))
    if ny * nx < 1e5:
        plain = kjac.jacobi_fused_k(pp, rhs, 1 / nx, 1 / ny, 0.75, k, cavity=True)
        assert_close(got[0], plain[0], rtol=1e-5)
        assert_close(got[1], plain[1], rtol=1e-5)


@pytest.mark.parametrize("semantics", ["RUST", "JS"])
@pytest.mark.parametrize("profile", ["UNIFORM", "PARABOLIC", "PARABOLIC_UPPER"])
@pytest.mark.parametrize("shape,cylinders", [((24, 40), 1), ((47, 65), 2), ((97, 130), 3)])
def test_correct_bc_cavity(cuda, shape, cylinders, profile, semantics):
    """Kernel 3's CAVITY instance (the one-launch form) against the plain
    corrector, the cavity BCs and the three maxima."""
    grid = _cavity_grid(*shape, cylinders)
    args = fields(1, grid, cuda) + fields(2, grid, cuda)[:2]
    rest = (DT, INLET, grid, tc.InletProfile[profile], CAVITY, tc.Semantics[semantics])
    n = ksub.correct_bc.cavity_launches
    got = ksub.correct_bc(*args, *rest)
    assert ksub.correct_bc.cavity_launches == n + 1
    ref = ksub.correct_bc_plain(*(a.cpu() for a in args), *rest)
    _same_bits([x.cpu() for x in got], ref, f"correct_bc cavity {shape} {profile}")


def _cavity_rounds_scene(ny, nx, cylinders=1, **opts):
    return tc.make_scene(_cavity_grid(ny, nx, cylinders), tc.SimulationParams(
        dt=0.002, viscosity=1e-2, flow_case=CAVITY,
        inlet_profile=tc.InletProfile.PARABOLIC if cylinders > 1 else tc.InletProfile.UNIFORM),
        tc.solver_options_for(RUST, **opts))


@pytest.mark.parametrize("schedule", ["exits", "all sweeps"])
@pytest.mark.parametrize("shape,cylinders", [((24, 40), 1), ((24, 41), 2), ((24, 42), 1),
                                             ((24, 43), 3), ((37, 53), 2)])
def test_rounds_cavity(cuda, shape, cylinders, schedule):
    """Kernel 4's CAVITY instance in its forms against the plain version:
    the same outer rounds and sweeps, u and v at the channel form's bound,
    p and p' with the mean difference removed (the all-Neumann solve's
    gauge); the cluster form at every C it can split the grid over, the
    slab form and the cooperative form bit for bit the same."""
    ny, nx = shape
    kw = {} if schedule == "exits" else {"jacobi_iters": 40, "outer_corrector_rounds": 3}
    scene = _cavity_rounds_scene(ny, nx, cylinders, **kw)
    u, v, p, rhs = fields(4, scene.grid, cuda, scale=0.1)
    pp0, _ = _cavity_pp(5, shape)
    args = (u, v, p, 0.01 * pp0.to(cuda), (10 if schedule == "exits" else 1000) * rhs)
    n = krounds.solve_correct_rounds.cavity_launches
    b = krounds.solve_correct_rounds(*args, 0.002, 1.0, scene, form="cooperative")
    ref = krounds.solve_correct_rounds_plain(*(a.cpu() for a in args), 0.002, 1.0, scene)
    assert b[5].tolist() == ref[5].tolist()
    if schedule == "all sweeps":
        assert ref[5].tolist() == [3, 160]
    for name, x, y in zip(("u", "v"), b, ref):
        torch.testing.assert_close(x.cpu(), y, rtol=1e-4, atol=5e-5, msg=name)
    for name, x, y in zip(("p", "pp"), b[2:4], ref[2:4]):
        d = x.cpu() - y
        assert float((d - d.mean()).abs().max()) <= 1e-4 * max(1.0, float(y.abs().max())), name
    assert float(b[3][0, 0]) == 0.0 and torch.equal(b[3][:, -1], b[3][:, -2])
    sizes = _cluster_sizes(ny, nx)
    for ctas in [*sizes, "slab"]:
        kw = {"form": "slab"} if ctas == "slab" else {"form": "cluster", "ctas": ctas}
        a = krounds.solve_correct_rounds(*args, 0.002, 1.0, scene, **kw)
        assert a[5].tolist() == b[5].tolist(), ctas
        for name, x, y in zip(("u", "v", "p", "pp", "err"), a, b):
            assert torch.equal(x, y), (ctas, name, float((x - y).abs().max()))
    assert krounds.solve_correct_rounds.cavity_launches == n + 2 + len(sizes)


@pytest.mark.parametrize("route", ["rounds", "fused", "fdm", "multigrid"])
def test_cavity_steps_match_cpu_path(cuda, route):
    """Five cavity steps on the card and on the CPU path: u and v, p with
    the mean difference removed (MULTIGRID's three cycles leave the
    smoothest modes apart: u, v alone, as the channel's are held)."""
    grid = _cavity_grid(48, 64, cylinders=0)
    solver = {"fdm": "FDM", "multigrid": "MULTIGRID"}.get(route, "JACOBI")
    opts = dict(substep_impl="pallas", jacobi_tol=0.0, outer_corrector_rounds=0,
                early_exit=False) if route == "fused" else {}
    scene = tc.make_scene(grid, tc.SimulationParams(
        dt=0.002, viscosity=1e-2, flow_case=CAVITY,
        pressure_solver=tc.PressureSolver[solver],
        inlet_profile=tc.InletProfile.PARABOLIC), tc.solver_options_for(RUST, **opts))
    run = tc.make_run(scene, 5)
    a, _ = run(scene.init_state(cuda))
    b, _ = run(scene.init_state("cpu"))
    for f in ("u", "v"):
        assert_close(getattr(a, f), getattr(b, f), rtol=1e-5)
    if route != "multigrid":
        d = (a.p.cpu() - b.p).double()
        assert float((d - d.mean()).abs().max()) <= 1e-5 * max(1.0, float(b.p.abs().max()))


def test_cavity_slab_rounds_route_like_cpu(cuda, monkeypatch):
    """The rounds route on a cavity that kernel 4's slab form takes
    (1024x512, Re = 1000 at cavity_1024's dt): kernel 1, then the slab
    form, five steps from step 50 of the lid's ramp like the CPU path."""
    grid = _cavity_grid(512, 1024, cylinders=0)
    assert kcl.plan("rounds", 1, grid.ny, grid.nx, cuda, cavity=True).form == "slab"
    scene = tc.make_scene(grid, tc.SimulationParams(dt=1e-4, viscosity=1e-3,
                                                    flow_case=CAVITY),
                          tc.solver_options_for(RUST))
    n_slab = krounds.solve_correct_rounds.slab_launches
    counts = _rounds_steps_match(monkeypatch, scene, cuda, 5, start=50)
    assert krounds.solve_correct_rounds.slab_launches == n_slab + 5
    assert max(r for r, _ in counts) > 0, counts  # an outer round ran


def test_cavity_ghia_re100_on_the_card(cuda):
    """The steady Re = 100 cavity against Ghia et al. (1982) as
    tests/test_physics.py:134-170 runs it: 8000 steps through the rounds
    kernel's CAVITY instance, max deviation below 0.06."""
    from cfd_demo_tpu_torch.validation import GHIA_STEPS, ghia_deviation, ghia_scene
    scene = ghia_scene()
    n = krounds.solve_correct_rounds.cavity_launches
    state, _ = tc.make_run(scene, GHIA_STEPS)(scene.init_state(cuda))
    assert krounds.solve_correct_rounds.cavity_launches == n + GHIA_STEPS
    assert float(state.res_u) < 1e-4, "not at steady state"
    du, dv = ghia_deviation(state)
    assert du < 0.06 and dv < 0.06, (du, dv)


# ---------------------------------------------------------------------------
# CAVITY flow with MG_PRODUCTION: kernels 6-9, 18's ring and 19's CAVITY
# instances, and the cavity's production steps
# ---------------------------------------------------------------------------

def _assert_cavity_ring(p):
    from cfd_demo_tpu_torch.ops.poisson import _apply_pprime_bcs_cavity
    p = p.cpu()
    assert torch.equal(p, _apply_pprime_bcs_cavity(p)) and float(p[0, 0]) == 0.0


@pytest.mark.parametrize("shape,k,emit_res", [((64, 97), 3, True), ((37, 53), 3, False),
                                              ((40, 96), 0, True), ((128, 130), 5, True)])
def test_mgp_res_cavity(cuda, shape, k, emit_res):
    """Kernel 6's CAVITY instance against its plain version, at the
    channel instance's bounds."""
    ny, nx = shape
    pp, rhs = _cavity_pp(21, shape)
    dx, dy = 1 / nx, 1 / ny
    n = kmgp.jacobi_fused_k_res.cavity_launches
    got = kmgp.jacobi_fused_k_res(pp.to(cuda), rhs.to(cuda), dx, dy, 0.75, k, emit_res,
                                  cavity=True)
    assert kmgp.jacobi_fused_k_res.cavity_launches == n + 1
    ref = kmgp.jacobi_fused_k_res_plain(pp, rhs, dx, dy, 0.75, k, emit_res, cavity=True)
    tol = _res_tol(ref[0], rhs, dx, dy)
    assert_close(got[0], ref[0], rtol=1e-5)
    if emit_res:
        torch.testing.assert_close(got[1].cpu(), ref[1], rtol=0, atol=tol)
    else:
        assert got[1] is None
    torch.testing.assert_close(got[2].cpu(), ref[2], rtol=1e-3, atol=tol)
    _assert_cavity_ring(got[0])


@pytest.mark.parametrize("shape,k", [((64, 96), 3), ((38, 130), 4), ((40, 96), 0)])
def test_mgp_restrict_and_corr_cavity(cuda, shape, k):
    """Kernels 7 and 8's CAVITY instances against their plain versions,
    kernel 8 fed the x pass of an all-Neumann prolongation."""
    ny, nx = shape
    pp, rhs = _cavity_pp(22, shape)
    dx, dy = 1 / nx, 1 / ny
    n7, n8 = (kmgp.jacobi_fused_k_restrict.cavity_launches,
              kmgp.jacobi_fused_k_corr.cavity_launches)
    got = kmgp.jacobi_fused_k_restrict(pp.to(cuda), rhs.to(cuda), dx, dy, 0.75, k,
                                       cavity=True)
    ref = kmgp.jacobi_fused_k_restrict_plain(pp, rhs, dx, dy, 0.75, k, cavity=True)
    tol = _res_tol(ref[0], rhs, dx, dy)
    assert_close(got[0], ref[0], rtol=1e-5)
    torch.testing.assert_close(got[1].cpu(), ref[1], rtol=0, atol=tol)
    torch.testing.assert_close(got[2].cpu(), ref[2], rtol=1e-3, atol=tol)
    _assert_cavity_ring(got[0])
    g = torch.Generator().manual_seed(23)
    e_c = 0.05 * torch.randn(((ny - 2) // 2, (nx - 2) // 2), generator=g)
    row = _cc_prolong_x(e_c, nx - 2, False).contiguous()
    got = kmgp.jacobi_fused_k_corr(ref[0].to(cuda), rhs.to(cuda), row.to(cuda),
                                   dx, dy, 0.75, k, cavity=True)
    ref = kmgp.jacobi_fused_k_corr_plain(ref[0], rhs, row, dx, dy, 0.75, k, cavity=True)
    assert_close(got[0], ref[0], rtol=1e-5)
    torch.testing.assert_close(got[1].cpu(), ref[1], rtol=1e-3,
                               atol=_res_tol(ref[0], rhs, dx, dy))
    assert float(got[2]) == float(got[0].abs().max())
    torch.testing.assert_close(got[2].cpu(), ref[2], rtol=1e-5, atol=0)
    _assert_cavity_ring(got[0])
    assert (kmgp.jacobi_fused_k_restrict.cavity_launches,
            kmgp.jacobi_fused_k_corr.cavity_launches) == (n7 + 1, n8 + 1)


@pytest.mark.parametrize("shape", [(64, 96), (63, 97), (9, 1), (1, 9)])
@pytest.mark.parametrize("d_mult", [1.0, 1.5, 16.5 / 32])
def test_cc_sweeps_all_neumann(cuda, shape, d_mult):
    """Kernel 9 with east_dirichlet=False (the cavity's coarse levels)
    against its plain version, at the channel instance's bounds."""
    g = torch.Generator().manual_seed(24)
    p = 0.1 * torch.randn(shape, generator=g)
    rhs = torch.randn(shape, generator=g)
    dx, dy = 1 / max(shape), 1 / min(shape)
    n = kmgp.cc_sweeps.cavity_launches
    for emit_res in (True, False):
        got = kmgp.cc_sweeps(p.to(cuda), rhs.to(cuda), dx, dy, 0.75, 3, d_mult * dx,
                             emit_res, east_dirichlet=False)
        ref = kmgp.cc_sweeps_plain(p, rhs, dx, dy, 0.75, 3, d_mult * dx, emit_res,
                                   east_dirichlet=False)
        torch.testing.assert_close(got[0].cpu(), ref[0], rtol=1e-5, atol=1e-5)
        if emit_res:
            torch.testing.assert_close(got[1].cpu(), ref[1], rtol=0,
                                       atol=_res_tol(ref[0], rhs, dx, dy))
        else:
            assert got[1] is None
    assert kmgp.cc_sweeps.cavity_launches == n + 2


@pytest.mark.parametrize("shape", MG_SHAPES)
@pytest.mark.parametrize("k", [0, 3, 10])
def test_mgp_smooth_cavity(cuda, shape, k):
    """Kernel 19's CAVITY instance on both routes (one block, one sweep a
    launch) against its plain version."""
    pp, rhs = _cavity_pp(25, shape)
    dx, dy = 1 / shape[1], 1 / shape[0]
    n = kmg.mgp_smooth.cavity_launches
    got = kmg.mgp_smooth(pp.to(cuda), rhs.to(cuda), dx, dy, 0.75, k, cavity=True)
    assert kmg.mgp_smooth.cavity_launches == n + (k > 0)
    ref = kmg.mgp_smooth_plain(pp, rhs, dx, dy, 0.75, k, cavity=True)
    ar = 0.75 / (2 / dx ** 2 + 2 / dy ** 2)
    torch.testing.assert_close(got.cpu(), ref, rtol=0,
                               atol=_sweep_tol(k, ref, ar * float(rhs.abs().max())))
    _assert_cavity_ring(got)


@pytest.mark.parametrize("shape", MG_SHAPES)
def test_mg_prolong_add_cavity_ring(cuda, shape):
    """Kernel 18 with the cavity's p' BCs of the sum: the plain version's
    operations, 1 ulp of max|out| allowed."""
    pp, _ = _cavity_pp(26, shape)
    g = torch.Generator().manual_seed(27)
    e = torch.randn(kmg.coarse_shape(*shape), generator=g)
    n = kmg.mg_prolong_add.cavity_launches
    got = kmg.mg_prolong_add(e.to(cuda), pp.to(cuda), True, cavity=True)
    assert kmg.mg_prolong_add.cavity_launches == n + 1
    ref = kmg.mg_prolong_add_plain(e, pp, True, cavity=True)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=EPS * float(ref.abs().max()))
    _assert_cavity_ring(got)


CAVITY_MGP = ("jacobi_fused_k_res", "jacobi_fused_k_restrict", "jacobi_fused_k_corr",
              "cc_sweeps")


@pytest.mark.parametrize("nx,ny,opts", [
    (64, 48, {"substep_impl": "pallas"}), (65, 47, {}), (64, 48, {"mgp_scheme": "legacy"}),
    (64, 48, {"mgp_fixed_cycles": 2})], ids=["aligned", "odd", "legacy", "fixed-cycles"])
def test_cavity_production_steps_match_cpu_path(cuda, nx, ny, opts):
    """Three cavity MG_PRODUCTION steps on the card and on the CPU path:
    u and v to 1e-5, p' with the mean difference removed to its
    noise-floor spread (as the channel's production steps are held);
    every launch of the production kernels a CAVITY instance."""
    scene = tc.make_scene(_cavity_grid(ny, nx, cylinders=0), tc.SimulationParams(
        dt=0.002, viscosity=1e-2, flow_case=CAVITY,
        pressure_solver=tc.PressureSolver.MG_PRODUCTION),
        tc.solver_options_for(RUST, ramp_up_steps=2, mgp_coarse_stop=8, **opts))
    wrappers = [getattr(kmgp, n) for n in CAVITY_MGP] + [kmg.mgp_smooth, kmg.mg_prolong_add]
    before = [(w.launches, w.cavity_launches) for w in wrappers]
    run = tc.make_run(scene, 3)
    a, _ = run(scene.init_state(cuda))
    delta = [(w.launches - l0, w.cavity_launches - c0)
             for w, (l0, c0) in zip(wrappers, before)]
    assert all(n == c for n, c in delta) and sum(n for n, _ in delta) > 0, delta
    b, _ = run(scene.init_state("cpu"))
    for f in ("u", "v"):
        assert_close(getattr(a, f), getattr(b, f), rtol=1e-5)
    d = (a.p_prime.cpu() - b.p_prime).double()
    assert float((d - d.mean()).abs().max()) <= 1e-3 * max(1.0, float(b.p_prime.abs().max()))
    assert float(a.p_prime[0, 0]) == 0.0
