"""The port's vertex multigrid (MULTIGRID and the legacy MG_PRODUCTION
cycle) against cfd_demo_tpu on the CPU.

Inputs are made with numpy from a seed and given to both packages; the
JAX side runs its Pallas kernels in interpret mode (at lane stride 1 on
128-lane-padded arrays, as tests/test_mg_pallas.py does), the port's
wrappers their plain versions on CPU tensors. Tolerances:

- the plain pieces and ``multigrid`` against the JAX kit: bit for bit
  (the same operations in the same order, op by op);
- a kernel's plain version against its Pallas kernel: the sweeps
  16 eps k (max|p| + max|scaled rhs|), as the kernel's reciprocal
  multipliers round each sweep's three terms apart from the plain
  version's divisions, a few ulps of the largest term a sweep, which
  Jacobi's iteration (norm <= 1) carries without growth; the restriction
  30 eps (denom max|p| + max|rhs|), the residual's f32 cancellation floor
  (tests/test_projection.py:320); the prolongation 1 ulp of max|out|;
- the routing: which wrappers a solve calls, level by level.

tests/test_torch_mg_legacy.py holds the legacy MG_PRODUCTION solve,
tests/test_torch_mg_step.py the steps.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfd_demo_tpu.core import config as jcfg
from cfd_demo_tpu.kernels import jacobi_pallas as JK
from cfd_demo_tpu.kernels import mg_pallas as JM
from cfd_demo_tpu.ops import poisson as JP

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch import cells
from cfd_demo_tpu_torch.kernels import mg
from cfd_demo_tpu_torch.ops import poisson as TP

from conftest import l2

torch.set_num_threads(1)
EPS = float(np.finfo(np.float32).eps)
OMEGA = 0.75
SIZES = [(24, 16), (33, 17), (17, 33), (66, 200)]


def T(a):
    return torch.from_numpy(np.array(a))


def case(shape, seed, bc=False):
    """p (0.1 randn, BC-consistent when ``bc``), rhs (randn), dx, dy."""
    rng = np.random.default_rng(seed)
    p = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if bc:
        p = TP._apply_pprime_bcs(T(p)).numpy()
    return p, rng.standard_normal(shape).astype(np.float32), 1 / shape[1], 1 / shape[0]


def sweep_tol(k, p_ref, rhs_scaled):
    return 16 * EPS * max(k, 1) * (float(np.abs(np.asarray(p_ref)).max())
                                   + float(np.abs(np.asarray(rhs_scaled)).max()))


def res_tol(p, rhs, dx, dy):
    return 30 * EPS * ((2 / dx ** 2 + 2 / dy ** 2) * float(np.abs(p).max())
                       + float(np.abs(rhs).max()))


# ---------------------------------------------------------------------------
# The plain kit against the JAX one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SIZES)
def test_plain_kit_matches_jax_bitwise(shape):
    p, rhs, dx, dy = case(shape, 0)
    ny, nx = shape
    nyc, nxc = (ny + 1) // 2, (nx + 1) // 2
    jp, jr = jnp.asarray(p), jnp.asarray(rhs)
    for k in (0, 1, 5):
        np.testing.assert_array_equal(TP._mg_smooth(T(p), T(rhs), dx, dy, k).numpy(),
                                      np.asarray(JP._mg_smooth(jp, jr, dx, dy, k)))
    np.testing.assert_array_equal(TP._mg_residual(T(p), T(rhs), dx, dy).numpy(),
                                  np.asarray(JP._mg_residual(jp, jr, dx, dy)))
    np.testing.assert_array_equal(TP._mg_restrict(T(p), nxc, nyc).numpy(),
                                  np.asarray(JP._mg_restrict(jp, nxc, nyc)))
    e = np.random.default_rng(1).standard_normal((nyc, nxc)).astype(np.float32)
    np.testing.assert_array_equal(TP._mg_prolong(T(e), nx, ny).numpy(),
                                  np.asarray(JP._mg_prolong(jnp.asarray(e), nx, ny)))
    np.testing.assert_array_equal(
        TP._mgp_smooth(TP._apply_pprime_bcs(T(p)), T(rhs), dx, dy, OMEGA, 3).numpy(),
        np.asarray(JP._mgp_smooth(JP._apply_pprime_bcs(jp), jr, dx, dy, OMEGA, 3,
                                  JP._apply_pprime_bcs)))


@pytest.mark.parametrize("shape,pallas", [((64, 64), True), ((96, 160), False)])
def test_multigrid_matches_jax_and_multigrid_pallas(shape, pallas):
    """Three V-cycles from zero under the JS options (mg_cycles 3, 5 + 5
    sweeps, 10 at the coarsest): bit for bit against the JAX kit; at 64²
    one cycle against the interleaved Pallas kernels in interpret mode at
    the bound of tests/test_mg_pallas.py:31-34 (that file holds them
    against the JAX kit at 96x160 too, which this kit equals bit for
    bit)."""
    ny, nx = shape
    dx, dy = 1 / nx, 1 / ny
    rhs = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jopts = jcfg.solver_options_for(jcfg.Semantics.JS)
    topts = tc.solver_options_for(tc.Semantics.JS)
    got = TP.multigrid(torch.zeros(shape), T(rhs), dx, dy, topts)
    ref = JP.multigrid(jnp.zeros(shape, jnp.float32), jnp.asarray(rhs), dx, dy, jopts)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert float(got[1]) == float(ref[1])
    assert got[2].dtype == torch.int32 and int(got[2]) == int(ref[2]) == 3
    # One cycle through the Pallas kernels (each at every level; the
    # three-cycle graph triples the interpret-mode compile)
    one = dataclasses.replace(topts, mg_cycles=1)
    got = TP.multigrid(torch.zeros(shape), T(rhs), dx, dy, one)
    if pallas:
        pal = jax.jit(lambda r: JM.multigrid_pallas(
            jnp.zeros(shape, jnp.float32), r, dx, dy,
            dataclasses.replace(jopts, mg_cycles=1), interpret=True))(jnp.asarray(rhs))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(pal[0]), rtol=0, atol=1e-6)
        assert np.isclose(float(got[1]), float(pal[1]), rtol=1e-4, atol=1e-7)
    # the warm start is ignored (index.html:777)
    warm = TP.multigrid(torch.ones(shape), T(rhs), dx, dy, one)
    assert torch.equal(warm[0], got[0])


# ---------------------------------------------------------------------------
# Each kernel's plain version against its Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

NCY, NCX, NXP = 48, 100, 128  # stride 1, 128 lanes


def lanes(a):
    """A compact level padded to NXP lanes: the interleaved form at s = 1."""
    return jnp.pad(jnp.asarray(a), ((0, 0), (0, NXP - a.shape[1])))


@pytest.mark.parametrize("k", [1, 5, 10])
def test_mg_smooth_plain_matches_kernels_10_and_16(k):
    p, rhs, dx, dy = case((NCY, NCX), 2)
    got = mg.mg_smooth(T(p), T(rhs), dx, dy, k)  # CPU: the plain version
    assert torch.equal(got, mg.mg_smooth_plain(T(p), T(rhs), dx, dy, k))
    br = 1 / (2 / dx ** 2 + 2 / dy ** 2)
    tol = sweep_tol(k, got, br * rhs)
    ref10 = JK.mg_smooth_pallas(jnp.asarray(p), jnp.asarray(rhs), dx, dy, k,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref10), rtol=0, atol=tol)
    ref16 = JM.mg_smooth_int(lanes(p), lanes(rhs), dx, dy, 1, NCX, k, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref16)[:, :NCX], rtol=0, atol=tol)
    assert np.abs(got.numpy() - p).max() > 10 * tol  # the sweeps moved p


def test_mg_residual_restrict_plain_matches_kernel_17():
    p, rhs, dx, dy = case((NCY, NCX), 3)
    got = mg.mg_residual_restrict(T(p), T(rhs), dx, dy)
    assert tuple(got.shape) == (NCY // 2, NCX // 2)
    ref = JM.mg_residual_restrict_int(lanes(p), lanes(rhs), dx, dy, 1, NCX,
                                      interpret=True)
    ref = np.asarray(ref)[:, ::2][:, :NCX // 2]  # lane stride 2, compact
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=res_tol(p, rhs, dx, dy))
    ring = np.ones(got.shape, bool)
    ring[1:-1, 1:-1] = False
    assert not got.numpy()[ring].any()  # a residual's ring is 0


@pytest.mark.parametrize("bc", [False, True])
def test_mg_prolong_add_plain_matches_kernel_18(bc):
    p, _, _, _ = case((NCY, NCX), 4, bc=True)
    e = np.random.default_rng(5).standard_normal((NCY // 2, NCX // 2)).astype(np.float32)
    got = mg.mg_prolong_add(T(e), T(p), bc)
    ref = JM.mg_prolong_add_int(JM._interleave(jnp.asarray(e), 2, NXP), lanes(p), 1,
                                NCX, interpret=True)
    ref = np.asarray(ref)[:, :NCX]
    if bc:  # the legacy cycle's bc(p + prolong(e)) (JAX ops/poisson.py:663)
        ref = np.asarray(JP._apply_pprime_bcs(jnp.asarray(ref)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=EPS * float(np.abs(ref).max()))


@pytest.mark.parametrize("k", [3, 10])
def test_mgp_smooth_plain_matches_kernel_19(k):
    p, rhs, dx, dy = case((NCY, NCX), 6, bc=True)
    got = mg.mgp_smooth(T(p), T(rhs), dx, dy, OMEGA, k)
    ref = JM.mgp_smooth_int(lanes(p), lanes(rhs), dx, dy, 1, NCX, k, OMEGA, False,
                            interpret=True)
    ar = OMEGA / (2 / dx ** 2 + 2 / dy ** 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, :NCX], rtol=0,
                               atol=sweep_tol(k, got, ar * rhs))


def test_wrappers_validate_and_count_nothing_on_the_cpu():
    p, rhs, dx, dy = (T(a) if isinstance(a, np.ndarray) else a for a in case((9, 7), 7))
    with pytest.raises(ValueError, match="3x3"):
        mg.mg_smooth(p[:2].contiguous(), rhs[:2].contiguous(), dx, dy, 1)
    with pytest.raises(ValueError, match="k must be"):
        mg.mgp_smooth(p, rhs, dx, dy, OMEGA, -1)
    with pytest.raises(ValueError, match="shape"):
        mg.mg_prolong_add(torch.zeros(4, 4), p)  # the next level is 5x4
    with pytest.raises(ValueError, match="contiguous"):
        mg.mg_residual_restrict(p.t(), rhs.t(), dx, dy)
    wrappers = (mg.mg_smooth, mg.mg_residual_restrict, mg.mg_prolong_add, mg.mgp_smooth)
    before = [w.launches for w in wrappers]
    mg.mg_smooth(p, rhs, dx, dy, 2)
    mg.mg_residual_restrict(p, rhs, dx, dy)
    mg.mg_prolong_add(torch.zeros(5, 4), p, True)
    mg.mgp_smooth(p, rhs, dx, dy, OMEGA, 2)
    assert [w.launches for w in wrappers] == before


# ---------------------------------------------------------------------------
# Routing: which wrappers a solve calls
# ---------------------------------------------------------------------------

def _topts(**kw):
    return tc.solver_options_for(tc.Semantics.RUST, **kw)


NAMES = ("mg_smooth", "mg_residual_restrict", "mg_prolong_add", "mgp_smooth")


def _spy_kit(monkeypatch):
    calls = []
    for name in NAMES:
        for suffix in ("", "_plain"):
            fn = getattr(mg, name + suffix)
            monkeypatch.setattr(mg, name + suffix,
                                lambda *a, _f=fn, _n=name + suffix, **k:
                                (calls.append((_n, a)), _f(*a, **k))[1])
    return calls


@pytest.mark.parametrize("impl", ["auto", "jnp"])
@pytest.mark.parametrize("solver", ["multigrid", "legacy"])
def test_cycles_route_to_the_kernels(monkeypatch, impl, solver):
    """Every level runs the wrappers (the plain versions with "jnp"):
    800x264 coarsens through 8 levels to one of 3 rows and 7 columns,
    where the cycle turns (mg_coarsest 4), two smoothings a level; the
    legacy cycle prolongs with the BCs."""
    calls = _spy_kit(monkeypatch)
    ny, nx = 264, 800
    rhs = T(np.random.default_rng(10).standard_normal((ny, nx)).astype(np.float32))
    opts = _topts(pressure_impl=impl, mgp_scheme="legacy", mgp_max_cycles=1)
    if solver == "multigrid":
        TP.multigrid(torch.zeros(ny, nx), rhs, 1 / nx, 1 / ny,
                     dataclasses.replace(opts, mg_cycles=1))
        want = {"mg_smooth", "mg_residual_restrict", "mg_prolong_add"}
    else:
        TP.multigrid_production(torch.zeros(ny, nx), rhs, 1 / nx, 1 / ny, opts, 0.0)
        want = {"mgp_smooth", "mg_residual_restrict", "mg_prolong_add"}
    names = [n for n, _ in calls]
    wrappers = {n for n in names if not n.endswith("_plain")}
    assert wrappers == (want if impl == "auto" else set())
    plain = {n[:-len("_plain")] for n in names if n.endswith("_plain")}
    assert plain == want  # on CPU tensors the wrappers run their plain versions
    smooth = ("mg_smooth" if solver == "multigrid" else "mgp_smooth") + (
        "" if impl == "auto" else "_plain")
    levels = [tuple(a[0].shape) for n, a in calls if n == smooth]
    assert len(levels) == 2 * cells.vertex_levels(ny, nx, opts.mg_coarsest) == 16
    assert levels[0] == (264, 800) and (3, 7) in levels
    prolong = "mg_prolong_add" + ("" if impl == "auto" else "_plain")
    bcs = [a[2] for n, a in calls if n == prolong]
    assert len(bcs) == 7 and all(b == (solver == "legacy") for b in bcs)
