"""The port's FDM bottom solve (ops/fdm.py) against cfd_demo_tpu/ops/fdm.py.

Both run on the CPU from the same numpy inputs. The port multiplies the
f32 bases in f64 and rounds each product to f32 (never TF32), where the
JAX package multiplies in f32: the solutions agree to a few ulps of the
solution's scale, and each solves the folded operator to the f32 noise
floor of tests/test_projection.py:259-262.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfd_demo_tpu.ops import fdm as jfdm
from cfd_demo_tpu.ops.poisson import _cc_residual as j_cc_residual

from cfd_demo_tpu_torch.ops import fdm as tfdm
from cfd_demo_tpu_torch.ops.poisson import _cc_residual

torch.set_num_threads(1)
EPS = float(np.finfo(np.float32).eps)


def _floor(e, r, dx, dy, mult):
    """mult x the f32 floor of evaluating r - A e (test_projection.py:259)."""
    return mult * EPS * ((2 / dx ** 2 + 2 / dy ** 2) * float(np.abs(e).max())
                         + float(np.abs(r).max()))


@pytest.mark.parametrize("shape,dx,dy,d_mult", [
    ((40, 56), 1 / 56, 1 / 40, 1.0),     # the d = h DCT bases
    ((38, 54), 0.3, 0.2, 1.5),           # the d != h eigh bases
    ((64, 64), 0.23, 0.23, 16.5 / 32),   # the 2048² bottom: d = 16.5 dx, h = 32 dx
    ((63, 33), 0.2, 0.3, 1.0),           # odd sides, DCT bases
    ((96, 17), 0.1, 0.4, 2.5),           # the stop size on the long side
    ((8, 1), 0.32, 0.4, 0.9 / 0.32),     # width-1 axis (test_projection.py:531)
    ((1, 8), 0.32, 0.4, 0.9 / 0.32),
])
def test_fdm_solve_interior_matches_jax(shape, dx, dy, d_mult):
    """The CHANNEL operator (Dirichlet outlet); the all-Neumann one,
    CAVITY's, is held by tests/test_torch_cavity.py."""
    rng = np.random.default_rng(9)
    r = rng.standard_normal(shape).astype(np.float32)
    d_wall = d_mult * dx
    want = np.asarray(jfdm.fdm_solve_interior(jnp.asarray(r), dx, dy, True,
                                              d_wall))
    got = tfdm.fdm_solve_interior(torch.from_numpy(r), dx, dy, d_wall).numpy()
    # f64 against f32 products: a few ulps of the solution's scale.
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=64 * EPS * float(np.abs(want).max()))
    # and each solves the folded operator the coarse levels smooth
    res = _cc_residual(torch.from_numpy(got), torch.from_numpy(r), dx, dy,
                       d_wall).numpy()
    assert np.abs(res).max() <= _floor(got, r, dx, dy, 64)
    j_res = np.asarray(j_cc_residual(jnp.asarray(got), jnp.asarray(r), dx, dy,
                                     True, d_wall))
    np.testing.assert_allclose(res, j_res, rtol=0, atol=_floor(got, r, dx, dy, 4))


@pytest.mark.parametrize("m,dirichlet", [(1, True), (7, False), (64, True),
                                         (1023, True), (2046, False)])
def test_dct_basis_matches_jax(m, dirichlet):
    """Same int32 residues and 4 sin^2(theta/2) eigenvalues; torch's and
    XLA's f32 sin and cos may differ in the last ulp."""
    q_j, lam_j = jfdm._dct_basis(m, dirichlet)
    q_t, lam_t = tfdm._dct_basis(m, dirichlet)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=0, atol=4 * EPS)
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=4 * EPS,
                               atol=0)
    if not dirichlet:
        assert float(lam_t[0]) == 0.0  # the gauge mode stays exactly 0
    else:
        assert float(lam_t[0]) > 0.0


def test_mulmod_i32_past_the_int32_wrap():
    """test_projection.py:500: the limb-split residues equal exact integer
    arithmetic past m = 23171, where (2i+1)(2k+1) wraps int32."""
    m = 30000
    period = 2 * (4 * m + 2)
    idx = np.array([0, 1, 12345, 23170, 23171, 29999], np.int64)
    a = 2 * idx + 1
    exact = (a[:, None] * a[None, :]) % period
    a32 = torch.from_numpy(a.astype(np.int32))
    got = tfdm._mulmod_i32(a32[:, None], a32[None, :], period)
    np.testing.assert_array_equal(got.numpy(), exact)


@pytest.mark.parametrize("m,h,right,d", [(1, 0.32, True, 0.9), (1, 0.32, False, 0.0),
                                         (5, 0.1, True, 0.15), (6, 0.2, False, 0.0)])
def test_t1d_is_the_jax_operator(m, h, right, d):
    np.testing.assert_array_equal(tfdm._t1d(m, h, right, d),
                                  jfdm._t1d(m, h, right, d))


def test_fdm_ignores_reduced_precision_matmul_flags():
    """The products never take a reduced-precision path, whatever the
    caller set: on the CPU "medium" turns f32 matmuls into bf16 ones."""
    rng = np.random.default_rng(4)
    r = torch.from_numpy(rng.standard_normal((40, 56)).astype(np.float32))
    args = (0.3, 0.2, 0.45)
    want = tfdm.fdm_solve_interior(r, *args)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        got = tfdm.fdm_solve_interior(r, *args)
    finally:
        torch.set_float32_matmul_precision(before)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
