"""The port's plain ops against cfd_demo_tpu.ops on the CPU.

Same inputs (numpy, seeded) through both packages. Masks must be equal
exactly; fields agree to 1e-6 x max(1, max|ref|), the bound of
tests/test_substep_pallas.py (float32 rounding differences only).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfd_demo_tpu.core import config as jcfg
from cfd_demo_tpu.core.masks import masks_traced as j_masks
from cfd_demo_tpu.ops import bc as jbc
from cfd_demo_tpu.ops import corrector as jcorr
from cfd_demo_tpu.ops import divergence as jdiv
from cfd_demo_tpu.ops import poisson as jpois
from cfd_demo_tpu.ops import predictor as jpred
from cfd_demo_tpu.ops import schemes as jsch
from cfd_demo_tpu.ops import stencil as jst

from cfd_demo_tpu_torch.core import config as tcfg
from cfd_demo_tpu_torch.core.masks import masks_traced as t_masks
from cfd_demo_tpu_torch.ops import bc as tbc
from cfd_demo_tpu_torch.ops import corrector as tcorr
from cfd_demo_tpu_torch.ops import divergence as tdiv
from cfd_demo_tpu_torch.ops import poisson as tpois
from cfd_demo_tpu_torch.ops import predictor as tpred
from cfd_demo_tpu_torch.ops import schemes as tsch
from cfd_demo_tpu_torch.ops import stencil as tst

torch.set_num_threads(1)

CPU = torch.device("cpu")
DT, NU, INLET = 0.003, 1e-4, 1.0


def grids(obstacle):
    """The grid of tests/test_substep_pallas.py:24 in both packages."""
    args = dict(nx=96, ny=64, lx=3.0, ly=2.0)
    return (jcfg.Grid(**args, obstacles=(jcfg.Cylinder(*obstacle),)),
            tcfg.Grid(**args, obstacles=(tcfg.Cylinder(*obstacle),)))


JG, TG = grids((0.8, 1.0, 0.3))


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


# Grids whose cylinder rims the masks must reproduce bit for bit: the ops
# grid, the golden grid (tests/test_golden.py:47), the 800x264 default
# scene and the 2048^2 benchmark scene (bench.py:78).
MASK_GRIDS = {
    "ops": dict(nx=96, ny=64, lx=3.0, ly=2.0, c=(0.8, 1.0, 0.3)),
    "golden": dict(nx=24, ny=16, lx=4.0, ly=1.5, c=(1.0, 0.75, 0.3)),
    "default": dict(nx=800, ny=264, lx=30.0, ly=10.0, c=(7.5, 5.0, 0.75)),
    "bench2048": dict(nx=2048, ny=2048, lx=30.0, ly=30.0, c=(7.5, 15.0, 0.75)),
}


@pytest.mark.parametrize("name", list(MASK_GRIDS))
def test_masks_exactly_equal(name):
    d = dict(MASK_GRIDS[name])
    c = d.pop("c")
    jg = jcfg.Grid(**d, obstacles=(jcfg.Cylinder(*c),))
    tg = tcfg.Grid(**d, obstacles=(tcfg.Cylinder(*c),))
    ref = j_masks(jg, jcfg.Semantics.RUST, jnp.float32)
    got = t_masks(tg, tcfg.Semantics.RUST, CPU)
    for r, g in zip(ref, got):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert np.asarray(r).any()


def test_masks_without_obstacles():
    g = tcfg.Grid(nx=16, ny=8, lx=1.0, ly=1.0)
    assert t_masks(g, tcfg.Semantics.RUST, CPU) == (None,) * 4


@pytest.mark.parametrize("dj,di", [(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1),
                                   (2, -2), (-2, 2)])
def test_shifted(dj, di):
    u, v, _, _ = fields(0, JG)
    for src, shape in ((u, v.shape), (v, u.shape), (v, v.shape)):
        ref = jst.shifted(J(src), shape, dj, di)
        np.testing.assert_array_equal(tst.shifted(T(src), shape, dj, di).numpy(),
                                      np.asarray(ref))


@pytest.mark.parametrize("shape", [(7, 9), (64, 97)])
def test_index_tensors(shape):
    np.testing.assert_array_equal(tst.col_index(shape, CPU).numpy(),
                                  np.asarray(jst.col_index(shape)))
    np.testing.assert_array_equal(tst.row_index(shape, CPU).numpy(),
                                  np.asarray(jst.row_index(shape)))


def test_first_faces():
    u, v, _, _ = fields(1, JG)
    nx, ny = JG.nx, JG.ny
    ref_u = jsch.u_faces(J(u), J(v), nx, ny, jcfg.VelocityScheme.FIRST, False)
    got_u = tsch.u_faces(T(u), T(v), nx, ny, tcfg.VelocityScheme.FIRST, False)
    ref_v = jsch.v_faces(J(u), J(v), nx, ny, jcfg.VelocityScheme.FIRST)
    got_v = tsch.v_faces(T(u), T(v), nx, ny, tcfg.VelocityScheme.FIRST)
    for r, g in zip(tuple(ref_u) + tuple(ref_v), tuple(got_u) + tuple(got_v)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_predictor_and_divergence():
    u, v, _, _ = fields(2, JG)
    nx, ny = JG.nx, JG.ny
    jm = j_masks(JG, jcfg.Semantics.RUST, jnp.float32)
    tm = t_masks(TG, tcfg.Semantics.RUST, CPU)
    rus, rvs = jpred.predict(J(u), J(v), DT, NU, JG.dx, JG.dy, nx, ny,
                             jcfg.VelocityScheme.FIRST, False, jm[0], jm[1])
    gus, gvs = tpred.predict(T(u), T(v), DT, NU, TG.dx, TG.dy, nx, ny,
                             tcfg.VelocityScheme.FIRST, False, tm[0], tm[1])
    assert_close(rus, gus)
    assert_close(rvs, gvs)
    # Divergence on the same u*, v* (the reference's), so the check
    # isolates the divergence op.
    assert_close(jdiv.divergence_rhs(rus, rvs, DT, JG.dx, JG.dy),
                 tdiv.divergence_rhs(T(rus), T(rvs), DT, TG.dx, TG.dy))


def test_corrector():
    u, v, p, pp = fields(3, JG)
    ref = jcorr.correct(J(u), J(v), J(p), J(pp), DT, JG.dx, JG.dy)
    got = tcorr.correct(T(u), T(v), T(p), T(pp), DT, TG.dx, TG.dy)
    for r, g in zip(ref, got):
        assert_close(r, g)


@pytest.mark.parametrize("inlet_as_tensor", [False, True])
def test_apply_bcs(inlet_as_tensor):
    u, v, _, _ = fields(4, JG)
    jm = j_masks(JG, jcfg.Semantics.RUST, jnp.float32)
    tm = t_masks(TG, tcfg.Semantics.RUST, CPU)
    inlet_t = torch.tensor(0.7) if inlet_as_tensor else 0.7
    ref = jbc.apply_bcs(J(u), J(v), JG, jcfg.InletProfile.UNIFORM, 0.7,
                        jm[2], jm[3])
    got = tbc.apply_bcs(T(u), T(v), TG, tcfg.InletProfile.UNIFORM, inlet_t,
                        tm[2], tm[3])
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _pp_rhs(seed, grid):
    """BC-consistent p' and a random rhs."""
    _, _, pp, rhs = fields(seed, grid)
    return np.asarray(jpois._apply_pprime_bcs(J(0.1 * pp))), rhs


def test_pprime_bcs_and_sweep():
    pp, rhs = fields(5, JG)[2:]
    np.testing.assert_array_equal(
        tpois._apply_pprime_bcs(T(pp)).numpy(),
        np.asarray(jpois._apply_pprime_bcs(J(pp))))
    rp, re = jpois._jacobi_sweep(J(pp), J(rhs), JG.dx, JG.dy, 0.75)
    gp, ge = tpois._jacobi_sweep(T(pp), T(rhs), TG.dx, TG.dy, 0.75)
    assert_close(rp, gp)
    assert_close(re, ge)


@pytest.mark.parametrize("tol,iters,early_exit", [
    (0.0, 12, True),     # fixed schedule, do-while
    (0.0, 12, False),    # fixed schedule, masked fixed trip
    (5e-3, 200, True),   # exits early at the exact sweep
    (5e-3, 200, False),  # masked: same fields and count
    (1.0, 5, True),      # converged at once: the do-while still sweeps once
])
def test_jacobi(tol, iters, early_exit):
    pp, rhs = _pp_rhs(6, JG)
    ref = jpois.jacobi(J(pp), J(rhs), JG.dx, JG.dy, 0.75, tol, iters,
                       early_exit=early_exit)
    got = tpois.jacobi(T(pp), T(rhs), TG.dx, TG.dy, 0.75, tol, iters,
                       early_exit=early_exit)
    assert_close(ref[0], got[0])
    assert_close(ref[1], got[1])
    assert int(ref[2]) == int(got[2])
